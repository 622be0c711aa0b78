"""Evaluation batch operators of the port (counterpart:
``alink_tpu/operator/batch/evaluation``)."""

from .eval_ops import (EvalBinaryClassBatchOp, EvalClusterBatchOp,
                       EvalMultiClassBatchOp, EvalRegressionBatchOp)

__all__ = ["EvalBinaryClassBatchOp", "EvalMultiClassBatchOp",
           "EvalRegressionBatchOp", "EvalClusterBatchOp"]
