"""Stream sources (counterpart: ``alink_tpu/operator/stream/source``)."""

from .sources import (BoundedTableStreamSource, MemSourceStreamOp,
                      TableSourceStreamOp)

__all__ = ["BoundedTableStreamSource", "MemSourceStreamOp",
           "TableSourceStreamOp"]
