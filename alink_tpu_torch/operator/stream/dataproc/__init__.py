"""Data-proc stream operators.

Counterpart: ``alink_tpu/operator/stream/dataproc/__init__.py``.
Ported: ``SplitStreamOp`` with ``get_side_stream``, which replays the
split with the same seed. Its random state is per drain (``_open`` on
the drain's copy of the operator), so every replay of a branch sees the
same rows. ``SampleStreamOp`` (a Bernoulli draw a row),
``AppendIdStreamOp`` (ids across the whole stream), ``FirstNStreamOp``
(ends the drain once satisfied), ``NumericalTypeCastStreamOp`` (the
batch op a micro-batch) and ``ShuffleStreamOp`` (within a micro-batch)
draw from the same generators as the JAX package's, so their rows are
equal. All run on the host.
"""

from __future__ import annotations

import numpy as np

from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import HasSeed, HasSelectedCols
from ...base import StreamOperator
from ..core import STOP, BaseStreamTransformOp, BatchApplyStreamOp


class SampleStreamOp(BaseStreamTransformOp, HasSeed):
    """Bernoulli sample of the stream (reference SampleStreamOp)."""

    RATIO = ParamInfo("ratio", float, optional=False)

    def _open(self, in_schema):
        self._rng = np.random.default_rng(self.get_seed() or 0)
        return in_schema

    def _transform(self, mt):
        mask = self._rng.random(mt.num_rows) < float(self.get_ratio())
        return mt.filter_mask(mask)


class SplitStreamOp(BaseStreamTransformOp, HasSeed):
    """Random split; main output = fraction, side stream = rest
    (reference SplitStreamOp)."""

    FRACTION = ParamInfo("fraction", float, optional=False)

    def _open(self, in_schema):
        self._rng = np.random.default_rng(self.get_seed() or 0)
        return in_schema

    def _transform(self, mt):
        mask = self._rng.random(mt.num_rows) < float(self.get_fraction())
        return mt.filter_mask(mask)

    def get_side_stream(self) -> "StreamOperator":
        """The complement stream (re-runs the split with the same seed)."""
        parent = self

        class _Rest(BaseStreamTransformOp):
            def _open(self, in_schema):
                self._rng = np.random.default_rng(parent.get_seed() or 0)
                return in_schema

            def _transform(self, mt):
                mask = self._rng.random(mt.num_rows) < float(parent.get_fraction())
                return mt.filter_mask(~mask)

        return _Rest().link_from(self._upstream)

    def link_from(self, in_op):
        self._upstream = in_op
        return super().link_from(in_op)


class AppendIdStreamOp(BaseStreamTransformOp):
    """Monotone row ids across the whole stream (reference AppendIdStreamOp)."""

    ID_COL = ParamInfo("id_col", str, default="append_id")

    def _open(self, in_schema):
        self._next = 0
        names = list(in_schema.names) + [self.get_id_col()]
        types = list(in_schema.types) + [AlinkTypes.LONG]
        return TableSchema(names, types)

    def _transform(self, mt):
        ids = np.arange(self._next, self._next + mt.num_rows, dtype=np.int64)
        self._next += mt.num_rows
        return mt.add_column(self.get_id_col(), ids, AlinkTypes.LONG)


class FirstNStreamOp(BaseStreamTransformOp):
    """Pass through the first N rows then stop."""

    N = ParamInfo("n", int, optional=False)

    def _open(self, in_schema):
        self._left = int(self.get_n())
        return in_schema

    def _transform(self, mt):
        if self._left <= 0:
            return STOP  # stop pulling upstream once satisfied
        take = min(self._left, mt.num_rows)
        self._left -= take
        return mt.first_n(take)


def _lazy_batch_cls(module: str, name: str):
    import importlib
    return getattr(importlib.import_module(module, package=__package__), name)


class NumericalTypeCastStreamOp(BatchApplyStreamOp, HasSelectedCols):
    """reference: stream/dataproc/NumericalTypeCastStreamOp."""
    TARGET_TYPE = ParamInfo("target_type", str, default="DOUBLE")

    def _batch_cls(self):
        return _lazy_batch_cls("...batch.dataproc", "NumericalTypeCastBatchOp")


class ShuffleStreamOp(BaseStreamTransformOp, HasSeed):
    """Shuffle within each micro-batch (stream shuffle is windowless)."""

    def _open(self, in_schema):
        self._rng = np.random.default_rng(self.get_seed() or 0)
        return in_schema

    def _transform(self, mt):
        return mt.take_rows(self._rng.permutation(mt.num_rows))
