"""Operator layer base classes.

Counterpart: ``alink_tpu/operator/base.py``. Ported: ``AlgoOperator``,
``BatchOperator`` (``link_from``, ``get_output_table``, ``get_schema``,
``get_side_output``),
``TableSourceBatchOp`` and ``StreamOperator`` (``link_from``,
``timed_batches``, ``micro_batches``, ``get_schema``, the sink registry
and ``execute``), and the link metering: every ``BatchOperator``
subclass's ``link_from`` (the eager execute path) reports
``alink_batch_op_seconds``, ``alink_batch_rows_in_total`` and
``alink_batch_rows_out_total`` by ``op`` and opens a ``link:<Op>``
span, and ``execute`` counts each sink's micro-batches and rows
(``alink_stream_sink_batches_total``, ``_rows_total``). Left out:
``link``, ``collect`` and the other conveniences, lazy printing and
collecting, statistics, train info, the SQL helpers and
``get_ml_env``: the port has no session mesh, and each entry point
takes its device explicitly.

Execution model (the JAX package's): batch operators compute eagerly
when linked; a stream is a host-side iterator of timed micro-batches
``(event_time, MTable)``, replayed from its sources on every drain.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, List, Optional

from ..common.metrics import get_registry, metrics_enabled
from ..common.mtable import MTable
from ..common.params import Params, WithParams
from ..common.tracing import trace_span, tracing_enabled
from ..common.types import TableSchema


def _meter_link_from(fn: Callable) -> Callable:
    """Wrap a ``link_from`` with batch-execute telemetry: wall time
    (``alink_batch_op_seconds{op=...}``) and rows in and out
    (``alink_batch_rows_{in,out}_total{op=...}``), and a ``link:<Op>``
    span under ``ALINK_TPU_TRACE`` (composite operators link their
    sub-operators inside their own link_from, so the spans nest).
    Applied to every BatchOperator subclass by ``__init_subclass__``;
    a reentrant link on the same instance records once, at the
    outermost frame."""

    @functools.wraps(fn)
    def metered(self, *inputs, **kwargs):
        mx = metrics_enabled()
        if (not mx and not tracing_enabled()) \
                or getattr(self, "_in_metered_link", False):
            return fn(self, *inputs, **kwargs)
        self._in_metered_link = True
        t0 = time.perf_counter()
        try:
            with trace_span(f"link:{type(self).__name__}", cat="batch") as sp:
                res = fn(self, *inputs, **kwargs)
                out_t = getattr(self, "_output", None)
                if out_t is not None:
                    sp.set(rows_out=out_t.num_rows)
        finally:
            self._in_metered_link = False
        if not mx:
            return res
        reg = get_registry()
        lbl = {"op": type(self).__name__}
        reg.observe("alink_batch_op_seconds", time.perf_counter() - t0, lbl)
        rows_in = sum(t.num_rows for t in
                      (getattr(i, "_output", None) for i in inputs)
                      if t is not None)
        reg.inc("alink_batch_rows_in_total", rows_in, lbl)
        out = getattr(self, "_output", None)
        if out is not None:
            reg.inc("alink_batch_rows_out_total", out.num_rows, lbl)
        return res

    metered._alink_metered = True
    return metered


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

    def __init_subclass__(cls, **kwargs):
        # every subclass's link_from (the eager execute path) is metered
        # (_meter_link_from), wrapped once a class at definition time
        super().__init_subclass__(**kwargs)
        lf = cls.__dict__.get("link_from")
        if lf is not None and callable(lf) \
                and not getattr(lf, "_alink_metered", False):
            cls.link_from = _meter_link_from(lf)

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._side_outputs: List[MTable] = []

    def get_schema(self) -> TableSchema:
        return self.get_output_table().schema

    def get_side_output(self, index: int) -> "BatchOperator":
        if index >= len(self._side_outputs):
            raise IndexError(f"side output {index} of {len(self._side_outputs)}")
        return TableSourceBatchOp(self._side_outputs[index])

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
            mx = metrics_enabled()
            lbl = {"op": type(s).__name__}
            # per-op gauge label: concurrent sink drains must not
            # overwrite each other's alink_prefetch_depth reading
            for mt in prefetch(s.micro_batches(), name=type(s).__name__):
                if mx:
                    reg = get_registry()
                    reg.inc("alink_stream_sink_batches_total", 1, lbl)
                    reg.inc("alink_stream_sink_rows_total", mt.num_rows, lbl)
                for sink in s._sinks:
                    sink(mt)
