"""Batch regression operators of the port (counterpart:
``alink_tpu/operator/batch/regression``): the linear family."""

from .linear import (LassoRegPredictBatchOp, LassoRegTrainBatchOp,
                     LinearRegPredictBatchOp, LinearRegTrainBatchOp,
                     LinearSvrPredictBatchOp, LinearSvrTrainBatchOp,
                     RidgeRegPredictBatchOp, RidgeRegTrainBatchOp)

__all__ = ["LinearRegTrainBatchOp", "LinearRegPredictBatchOp",
           "RidgeRegTrainBatchOp", "RidgeRegPredictBatchOp",
           "LassoRegTrainBatchOp", "LassoRegPredictBatchOp",
           "LinearSvrTrainBatchOp", "LinearSvrPredictBatchOp"]
