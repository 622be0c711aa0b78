"""Batch sources (counterpart: ``alink_tpu/operator/batch/source``)."""

from ...base import TableSourceBatchOp
from .sources import (BaseSourceBatchOp, CsvSourceBatchOp, DBSourceBatchOp,
                      LibSvmSourceBatchOp, MemSourceBatchOp,
                      MySqlSourceBatchOp, NumSeqSourceBatchOp,
                      RandomTableSourceBatchOp, TextSourceBatchOp)

__all__ = ["BaseSourceBatchOp", "MemSourceBatchOp", "CsvSourceBatchOp",
           "DBSourceBatchOp", "LibSvmSourceBatchOp", "MySqlSourceBatchOp",
           "TextSourceBatchOp", "NumSeqSourceBatchOp",
           "RandomTableSourceBatchOp", "TableSourceBatchOp"]
