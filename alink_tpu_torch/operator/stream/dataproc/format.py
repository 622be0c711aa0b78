"""Stream format operators.

Counterpart: ``alink_tpu/operator/stream/dataproc/format.py``: the
format-conversion matrix ``FORMAT_STREAM_OPS`` (each stream op applies
its batch twin of ``FORMAT_OPS`` to every micro-batch,
``BatchApplyStreamOp``; the reference generates a stream twin for each
batch format op) and ``JsonValueStreamOp`` (reference
stream/dataproc/JsonValueStreamOp.java). Host; none takes a device.
"""

from __future__ import annotations

from typing import Dict

from ...batch.dataproc import JsonValueBatchOp
from ...batch.dataproc.format import FORMAT_OPS
from ..core import BatchApplyStreamOp

FORMAT_STREAM_OPS: Dict[str, type] = {}

for _bname, _bcls in FORMAT_OPS.items():
    _sname = _bname.replace("BatchOp", "StreamOp")
    _ns = {"_batch_cls": (lambda cls=_bcls: (lambda self: cls))(),
           "__doc__": f"stream twin of {_bname}",
           "__module__": __name__}
    # re-declare the batch twin's param descriptors so WithParams accepts
    # the same kwargs on the stream op
    for _info in _bcls.param_infos().values():
        _ns[_info.name.upper()] = _info
    FORMAT_STREAM_OPS[_sname] = type(BatchApplyStreamOp)(
        _sname, (BatchApplyStreamOp,), _ns)

globals().update(FORMAT_STREAM_OPS)


class JsonValueStreamOp(BatchApplyStreamOp):
    """reference: stream/dataproc/JsonValueStreamOp.java"""
    JSON_PATH = JsonValueBatchOp.JSON_PATH
    OUTPUT_COLS = JsonValueBatchOp.OUTPUT_COLS
    SKIP_FAILED = JsonValueBatchOp.SKIP_FAILED
    SELECTED_COL = JsonValueBatchOp.SELECTED_COL

    def _batch_cls(self):
        return JsonValueBatchOp


# the reference's abstract base name for the stream format matrix
BaseFormatTransStreamOp = BatchApplyStreamOp

__all__ = sorted(FORMAT_STREAM_OPS) + ["JsonValueStreamOp",
                                       "BaseFormatTransStreamOp"]
