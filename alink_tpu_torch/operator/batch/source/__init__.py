"""Batch sources (counterpart: ``alink_tpu/operator/batch/source``)."""

from .sources import (BaseSourceBatchOp, CsvSourceBatchOp, LibSvmSourceBatchOp,
                      MemSourceBatchOp, TextSourceBatchOp)

__all__ = ["BaseSourceBatchOp", "CsvSourceBatchOp", "LibSvmSourceBatchOp",
           "MemSourceBatchOp", "TextSourceBatchOp"]
