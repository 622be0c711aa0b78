"""Batch sources (counterpart: ``alink_tpu/operator/batch/source``)."""

from .sources import BaseSourceBatchOp, MemSourceBatchOp

__all__ = ["BaseSourceBatchOp", "MemSourceBatchOp"]
