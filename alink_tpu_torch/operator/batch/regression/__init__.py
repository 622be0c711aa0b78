"""Batch regression operators of the port (counterpart:
``alink_tpu/operator/batch/regression``): the linear family, GLM,
isotonic regression and AFT survival regression."""

from .glm_ops import (AftModelMapper, AftSurvivalRegPredictBatchOp,
                      AftSurvivalRegTrainBatchOp, GlmEvaluationBatchOp,
                      GlmModelConverter, GlmModelMapper, GlmPredictBatchOp,
                      GlmTrainBatchOp, IsotonicModelConverter,
                      IsotonicModelMapper, IsotonicRegPredictBatchOp,
                      IsotonicRegTrainBatchOp)
from .linear import (LassoRegPredictBatchOp, LassoRegTrainBatchOp,
                     LinearRegPredictBatchOp, LinearRegTrainBatchOp,
                     LinearSvrPredictBatchOp, LinearSvrTrainBatchOp,
                     RidgeRegPredictBatchOp, RidgeRegTrainBatchOp)

__all__ = ["LinearRegTrainBatchOp", "LinearRegPredictBatchOp",
           "RidgeRegTrainBatchOp", "RidgeRegPredictBatchOp",
           "LassoRegTrainBatchOp", "LassoRegPredictBatchOp",
           "LinearSvrTrainBatchOp", "LinearSvrPredictBatchOp",
           "GlmTrainBatchOp", "GlmPredictBatchOp", "GlmEvaluationBatchOp",
           "GlmModelConverter", "GlmModelMapper",
           "IsotonicRegTrainBatchOp", "IsotonicRegPredictBatchOp",
           "IsotonicModelConverter", "IsotonicModelMapper",
           "AftSurvivalRegTrainBatchOp", "AftSurvivalRegPredictBatchOp",
           "AftModelMapper"]
