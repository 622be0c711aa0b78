"""Batch utility operators (counterpart: ``alink_tpu/operator/batch/utils``).
Only the model-apply operators are ported; the function operators
(``fn_ops.py``) wait for a later slice."""

from .model_map import MapBatchOp, ModelMapBatchOp

__all__ = ["MapBatchOp", "ModelMapBatchOp"]
