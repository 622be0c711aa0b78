"""Stream sources (counterpart: ``alink_tpu/operator/stream/source``)."""

from .sources import (BaseSourceStreamOp, BoundedTableStreamSource,
                      CsvSourceStreamOp, DBSourceStreamOp, LibSvmSourceStreamOp,
                      MemSourceStreamOp, MySqlSourceStreamOp,
                      NumSeqSourceStreamOp, RandomTableSourceStreamOp,
                      TableSourceStreamOp, TextSourceStreamOp)

__all__ = ["BaseSourceStreamOp", "BoundedTableStreamSource",
           "CsvSourceStreamOp", "DBSourceStreamOp", "LibSvmSourceStreamOp",
           "MemSourceStreamOp", "MySqlSourceStreamOp", "NumSeqSourceStreamOp",
           "RandomTableSourceStreamOp", "TableSourceStreamOp",
           "TextSourceStreamOp"]
