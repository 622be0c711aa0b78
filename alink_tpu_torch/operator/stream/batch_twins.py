"""Stateless stream twins of batch feature operators.

Counterpart: ``alink_tpu/operator/stream/batch_twins.py``. The reference
ships a ``*StreamOp`` for every stateless mapper-style batch op; each is
generated here from its batch class, applying the batch op to every
micro-batch (``BatchApplyStreamOp``): all twelve of the JAX package's
(Binarizer, Bucketizer, FeatureHasher, DCT and the eight vector ops).
``DCTStreamOp`` takes ``device=`` as ``DCTBatchOp`` does (``cuda``
unless the caller asks for the CPU; raises without it); the others run
on the host.
"""

from __future__ import annotations

from typing import Dict

from ..batch.dataproc import vector_ops as _vops
from ..batch.feature import feature_ops as _fops
from .core import BatchApplyStreamOp

_TWINS = {
    "BinarizerStreamOp": _fops.BinarizerBatchOp,
    "BucketizerStreamOp": _fops.BucketizerBatchOp,
    "FeatureHasherStreamOp": _fops.FeatureHasherBatchOp,
    "DCTStreamOp": _fops.DCTBatchOp,
    "VectorAssemblerStreamOp": _vops.VectorAssemblerBatchOp,
    "VectorElementwiseProductStreamOp": _vops.VectorElementwiseProductBatchOp,
    "VectorInteractionStreamOp": _vops.VectorInteractionBatchOp,
    "VectorNormalizeStreamOp": _vops.VectorNormalizeBatchOp,
    "VectorPolynomialExpandStreamOp": _vops.VectorPolynomialExpandBatchOp,
    "VectorSizeHintStreamOp": _vops.VectorSizeHintBatchOp,
    "VectorSliceStreamOp": _vops.VectorSliceBatchOp,
    "VectorSerializeStreamOp": _vops.VectorSerializeBatchOp,
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
