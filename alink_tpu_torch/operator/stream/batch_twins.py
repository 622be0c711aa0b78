"""Stateless stream twins of batch feature operators.

Counterpart: ``alink_tpu/operator/stream/batch_twins.py``. The reference
ships a ``*StreamOp`` for every stateless mapper-style batch op; each is
generated here from its batch class, applying the batch op to every
micro-batch (``BatchApplyStreamOp``). Ported: ``FeatureHasherStreamOp``.
The other twins (Binarizer, Bucketizer, DCT and the vector ops) join as
their batch ops are ported.
"""

from __future__ import annotations

from typing import Dict

from ..batch.feature import feature_ops as _fops
from .core import BatchApplyStreamOp

_TWINS = {
    "FeatureHasherStreamOp": _fops.FeatureHasherBatchOp,
}

TWIN_STREAM_OPS: Dict[str, type] = {}

for _sname, _bcls in _TWINS.items():
    _ns = {"_batch_cls": (lambda cls=_bcls: (lambda self: cls))(),
           "__doc__": f"stream twin of {_bcls.__name__} "
                      f"(reference stream op of the same name)",
           "__module__": __name__}
    for _info in _bcls.param_infos().values():
        _ns[_info.name.upper()] = _info
    TWIN_STREAM_OPS[_sname] = type(BatchApplyStreamOp)(
        _sname, (BatchApplyStreamOp,), _ns)

globals().update(TWIN_STREAM_OPS)
__all__ = sorted(TWIN_STREAM_OPS)
