"""Operator layer base classes.

Counterpart: ``alink_tpu/operator/base.py``. Ported: ``AlgoOperator``,
``BatchOperator`` (``link_from``, ``get_output_table``),
``TableSourceBatchOp`` and ``StreamOperator`` (``link_from``,
``timed_batches``, ``micro_batches``, ``get_schema``, the sink registry
and ``execute``). Left out: ``link``, ``collect`` and the other
conveniences, link metering, lazy printing and collecting, statistics,
train and model info, the SQL helpers, side outputs and ``get_ml_env``:
the port has no session mesh, and each entry point takes its device
explicitly.

Execution model (the JAX package's): batch operators compute eagerly
when linked; a stream is a host-side iterator of timed micro-batches
``(event_time, MTable)``, replayed from its sources on every drain.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ..common.mtable import MTable
from ..common.params import Params, WithParams
from ..common.types import TableSchema


class AlgoOperator(WithParams):
    """Base of all operators (reference operator/AlgoOperator.java)."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._output: Optional[MTable] = None

    def get_output_table(self) -> MTable:
        if self._output is None:
            raise RuntimeError(
                f"{type(self).__name__} has no output; link it to inputs first")
        return self._output


class BatchOperator(AlgoOperator):
    """Batch operator with link semantics (reference batch/BatchOperator.java)."""

    def link_from(self, *inputs: "BatchOperator") -> "BatchOperator":
        raise NotImplementedError(f"{type(self).__name__}.link_from")


class TableSourceBatchOp(BatchOperator):
    """Wrap an in-memory MTable as a source (reference TableSourceBatchOp)."""

    def __init__(self, table: MTable, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._output = table

    def link_from(self, *inputs):
        raise RuntimeError("TableSourceBatchOp is a source; it takes no inputs")


class StreamOperator(AlgoOperator):
    """Stream operator base (reference stream/StreamOperator.java).

    A stream is a host-side iterator of **timed micro-batches**
    ``(event_time, MTable)``. Event time is assigned by sources (batch
    index times ``time_per_batch``) and preserved by transforms;
    multi-input operators (FTRL predict's model + data co-process) merge
    their inputs in event-time order (``stream/core.py::merge_timed``).
    ``StreamOperator.execute()`` drains every registered sink DAG.
    """

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        # () -> iterator of (time, MTable)
        self._stream_fn: Optional[Callable[[], Any]] = None
        self._schema: Optional[TableSchema] = None
        self._sinks: List[Callable[[MTable], None]] = []

    def link_from(self, *inputs: "StreamOperator") -> "StreamOperator":
        raise NotImplementedError(f"{type(self).__name__}.link_from")

    def get_schema(self) -> TableSchema:
        if self._schema is None:
            raise RuntimeError(f"{type(self).__name__} schema unknown; link first")
        return self._schema

    def timed_batches(self):
        """Fresh iterator of (event_time, MTable)."""
        if self._stream_fn is None:
            raise RuntimeError(f"{type(self).__name__} has no stream; link it first")
        return self._stream_fn()

    def micro_batches(self):
        for _, mt in self.timed_batches():
            yield mt

    # registry of every stream termination in the session
    _session_streams: List["StreamOperator"] = []

    def _register(self):
        if self not in StreamOperator._session_streams:
            StreamOperator._session_streams.append(self)
        return self

    @staticmethod
    def execute():
        """Drain all registered stream DAGs to completion (reference
        StreamOperator.execute launching the stream job). Each DAG runs
        ``prefetch``ed in a background thread, so upstream work overlaps
        the sink (see stream/prefetch.py)."""
        from .stream.prefetch import prefetch
        streams = StreamOperator._session_streams
        StreamOperator._session_streams = []
        for s in streams:
            for mt in prefetch(s.micro_batches()):
                for sink in s._sinks:
                    sink(mt)
