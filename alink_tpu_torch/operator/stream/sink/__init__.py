"""Stream sinks (counterpart: ``alink_tpu/operator/stream/sink``)."""

from .sinks import (BaseSinkStreamOp, CheckpointSinkStreamOp,
                    CollectSinkStreamOp, CsvSinkStreamOp, LibSvmSinkStreamOp,
                    TextSinkStreamOp)

__all__ = ["BaseSinkStreamOp", "CheckpointSinkStreamOp",
           "CollectSinkStreamOp", "CsvSinkStreamOp", "LibSvmSinkStreamOp",
           "TextSinkStreamOp"]
