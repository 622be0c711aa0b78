"""Pipeline wrappers: regression.

Counterpart: ``alink_tpu/pipeline/regression.py`` (the reference's
pipeline/regression/): linear, ridge, lasso and SVR regression, each
with its Model, over the batch ops of ``operator/batch/regression``.
"""

from ..operator.batch.classification.linear import (_LinearPredictParams,
                                                    _LinearTrainParams)
from ..operator.batch.regression.linear import (LassoRegTrainBatchOp,
                                                LinearRegTrainBatchOp,
                                                LinearSvrTrainBatchOp,
                                                RidgeRegTrainBatchOp)
from ..operator.common.linear.mapper import LinearModelMapper
from .base import MapModel, Trainer


class _LinearParams(_LinearTrainParams, _LinearPredictParams):
    pass


class LinearRegressionModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LinearRegression(Trainer, _LinearParams):
    TRAIN_OP_CLS = LinearRegTrainBatchOp
    MODEL_CLS = LinearRegressionModel


class RidgeRegressionModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class RidgeRegression(Trainer, _LinearParams):
    TRAIN_OP_CLS = RidgeRegTrainBatchOp
    MODEL_CLS = RidgeRegressionModel
    LAMBDA = RidgeRegTrainBatchOp.LAMBDA


class LassoRegressionModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LassoRegression(Trainer, _LinearParams):
    TRAIN_OP_CLS = LassoRegTrainBatchOp
    MODEL_CLS = LassoRegressionModel
    LAMBDA = LassoRegTrainBatchOp.LAMBDA


class LinearSvrModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LinearSvr(Trainer, _LinearParams):
    TRAIN_OP_CLS = LinearSvrTrainBatchOp
    MODEL_CLS = LinearSvrModel
    TAU = LinearSvrTrainBatchOp.TAU
