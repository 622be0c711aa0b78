"""Evaluation batch operators of the port (counterpart:
``alink_tpu/operator/batch/evaluation``); only the binary one is
ported."""

from .eval_ops import EvalBinaryClassBatchOp

__all__ = ["EvalBinaryClassBatchOp"]
