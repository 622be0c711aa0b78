"""Stream sources (counterpart: ``alink_tpu/operator/stream/source``)."""

from .sources import (BoundedTableStreamSource, CsvSourceStreamOp,
                      LibSvmSourceStreamOp, MemSourceStreamOp,
                      TableSourceStreamOp, TextSourceStreamOp)

__all__ = ["BoundedTableStreamSource", "CsvSourceStreamOp",
           "LibSvmSourceStreamOp", "MemSourceStreamOp", "TableSourceStreamOp",
           "TextSourceStreamOp"]
