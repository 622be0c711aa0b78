"""Stream sinks (counterpart: ``alink_tpu/operator/stream/sink``)."""

from .sinks import (BaseSinkStreamOp, CheckpointSinkStreamOp,
                    CollectSinkStreamOp, CsvSinkStreamOp, DBSinkStreamOp,
                    JdbcRetractSinkStreamOp, LibSvmSinkStreamOp,
                    MySqlSinkStreamOp, TextSinkStreamOp)

__all__ = ["BaseSinkStreamOp", "CheckpointSinkStreamOp",
           "CollectSinkStreamOp", "CsvSinkStreamOp", "DBSinkStreamOp",
           "JdbcRetractSinkStreamOp", "LibSvmSinkStreamOp",
           "MySqlSinkStreamOp", "TextSinkStreamOp"]
