"""Stream format operators.

Counterpart: ``alink_tpu/operator/stream/dataproc/format.py``. Ported:
``JsonValueStreamOp`` (reference stream/dataproc/JsonValueStreamOp.java),
the batch ``JsonValueBatchOp`` applied to every micro-batch. The
format-conversion matrix (``FORMAT_STREAM_OPS``) waits for the batch
format ops.
"""

from __future__ import annotations

from ...batch.dataproc import JsonValueBatchOp
from ..core import BatchApplyStreamOp


class JsonValueStreamOp(BatchApplyStreamOp):
    """reference: stream/dataproc/JsonValueStreamOp.java"""
    JSON_PATH = JsonValueBatchOp.JSON_PATH
    OUTPUT_COLS = JsonValueBatchOp.OUTPUT_COLS
    SKIP_FAILED = JsonValueBatchOp.SKIP_FAILED
    SELECTED_COL = JsonValueBatchOp.SELECTED_COL

    def _batch_cls(self):
        return JsonValueBatchOp


__all__ = ["JsonValueStreamOp"]
