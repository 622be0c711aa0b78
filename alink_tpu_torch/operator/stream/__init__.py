"""Stream layer of the port (counterpart: ``alink_tpu/operator/stream``).
The sinks are exported here, as there; the other stream ops are imported
from their modules."""

from .sink import (BaseSinkStreamOp, CheckpointSinkStreamOp,
                   CollectSinkStreamOp, CsvSinkStreamOp, LibSvmSinkStreamOp,
                   TextSinkStreamOp)

__all__ = ["BaseSinkStreamOp", "CheckpointSinkStreamOp",
           "CollectSinkStreamOp", "CsvSinkStreamOp", "LibSvmSinkStreamOp",
           "TextSinkStreamOp"]
