"""Batch sinks (counterpart: ``alink_tpu/operator/batch/sink``)."""

from .sinks import (BaseSinkBatchOp, CsvSinkBatchOp, LibSvmSinkBatchOp,
                    TextSinkBatchOp)

__all__ = ["BaseSinkBatchOp", "CsvSinkBatchOp", "LibSvmSinkBatchOp",
           "TextSinkBatchOp"]
