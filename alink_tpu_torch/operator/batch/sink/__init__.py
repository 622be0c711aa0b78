"""Batch sinks (counterpart: ``alink_tpu/operator/batch/sink``)."""

from .sinks import (BaseSinkBatchOp, CsvSinkBatchOp, DBSinkBatchOp,
                    LibSvmSinkBatchOp, MemSinkBatchOp, MySqlSinkBatchOp,
                    TextSinkBatchOp)

__all__ = ["BaseSinkBatchOp", "CsvSinkBatchOp", "DBSinkBatchOp",
           "LibSvmSinkBatchOp", "MemSinkBatchOp", "MySqlSinkBatchOp",
           "TextSinkBatchOp"]
