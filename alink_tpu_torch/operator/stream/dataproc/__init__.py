"""Data-proc stream operators.

Counterpart: ``alink_tpu/operator/stream/dataproc/__init__.py``.
Ported: ``SplitStreamOp`` with ``get_side_stream``, which replays the
split with the same seed. Its random state is per drain (``_open`` on
the drain's copy of the operator), so every replay of a branch sees the
same rows. Not ported yet: the sample, append-id, first-N, type-cast
and shuffle stream ops.
"""

from __future__ import annotations

import numpy as np

from ....common.params import ParamInfo
from ....params.shared import HasSeed
from ...base import StreamOperator
from ..core import BaseStreamTransformOp


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
