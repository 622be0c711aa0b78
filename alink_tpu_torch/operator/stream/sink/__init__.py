"""Stream sinks (counterpart: ``alink_tpu/operator/stream/sink``)."""

from .sinks import (BaseSinkStreamOp, CollectSinkStreamOp, CsvSinkStreamOp,
                    LibSvmSinkStreamOp, TextSinkStreamOp)

__all__ = ["BaseSinkStreamOp", "CollectSinkStreamOp", "CsvSinkStreamOp",
           "LibSvmSinkStreamOp", "TextSinkStreamOp"]
