"""Stream sink operators.

Counterpart: ``alink_tpu/operator/stream/sink/sinks.py``. Ported:
``BaseSinkStreamOp`` and ``CollectSinkStreamOp``, the in-memory sink
that ``StreamOperator.execute()`` drains into. The file and checkpoint
sinks wait for the IO and durability slices.
"""

from __future__ import annotations

from typing import List, Optional

from ....common.mtable import MTable
from ....common.params import Params
from ...base import StreamOperator


class BaseSinkStreamOp(StreamOperator):
    def _consume(self, mt: MTable):  # pragma: no cover - interface
        raise NotImplementedError

    def link_from(self, in_op: StreamOperator) -> "BaseSinkStreamOp":
        try:
            self._schema = in_op.get_schema()
        except RuntimeError:
            self._schema = None  # upstream schema data-dependent

        self._stream_fn = in_op.timed_batches
        self._sinks.append(self._consume)
        return self._register()


class CollectSinkStreamOp(BaseSinkStreamOp):
    """Collect every micro-batch into one host table."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._batches: List[MTable] = []

    def _consume(self, mt: MTable):
        self._batches.append(mt)

    def get_and_remove_values(self) -> Optional[MTable]:
        out = None
        for mt in self._batches:
            out = mt if out is None else out.concat_rows(mt)
        self._batches = []
        return out
