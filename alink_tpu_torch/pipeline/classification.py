"""Pipeline wrappers: classification.

Counterpart: ``alink_tpu/pipeline/classification.py`` (the reference's
pipeline/classification/ shells over the batch ops, Trainer.java's
reflection pattern): ``LogisticRegression``, ``LinearSvm``, ``Softmax``
and ``Perceptron``, each with its Model. Each estimator carries both
train and predict params so the fitted model transforms directly. The
estimator trains on ``cuda`` unless given ``device=`` (``Trainer.fit``).
"""

from ..operator.batch.classification.linear import (
    LinearSvmTrainBatchOp, LogisticRegressionTrainBatchOp,
    PerceptronTrainBatchOp, SoftmaxTrainBatchOp, _LinearPredictParams,
    _LinearTrainParams)
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


class LinearSvmModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LinearSvm(Trainer, _LinearParams, HasPositiveLabelValueString):
    TRAIN_OP_CLS = LinearSvmTrainBatchOp
    MODEL_CLS = LinearSvmModel


class SoftmaxModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class Softmax(Trainer, _LinearParams):
    TRAIN_OP_CLS = SoftmaxTrainBatchOp
    MODEL_CLS = SoftmaxModel


class PerceptronModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class Perceptron(Trainer, _LinearParams):
    TRAIN_OP_CLS = PerceptronTrainBatchOp
    MODEL_CLS = PerceptronModel
