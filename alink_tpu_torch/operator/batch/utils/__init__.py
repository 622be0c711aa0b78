"""Batch utility operators (counterpart: ``alink_tpu/operator/batch/utils``):
the model-apply operators and the function operators of ``fn_ops.py``."""

from .fn_ops import (DataSetWrapperBatchOp, FlatMapBatchOp, PrintBatchOp,
                     UDFBatchOp, UDTFBatchOp)
from .model_map import MapBatchOp, ModelMapBatchOp

__all__ = ["DataSetWrapperBatchOp", "FlatMapBatchOp", "MapBatchOp",
           "ModelMapBatchOp", "PrintBatchOp", "UDFBatchOp", "UDTFBatchOp"]
