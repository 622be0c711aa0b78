"""Stream runtime core: per-batch transforms and event-time merging.

Counterpart: ``alink_tpu/operator/stream/core.py`` (the Flink DataStream
substrate, reference stream/StreamOperator.java and the per-op
RichFlatMap / CoFlatMap functions, replaced by lazy generators of
``(event_time, MTable)``). Ported: :func:`merge_timed`, ``STOP``,
:class:`BaseStreamTransformOp` (its per-drain shallow copy of the
operator and its data-dependent schema, and the per-batch telemetry:
a ``stream:<Op>`` span and ``alink_stream_batch_seconds``,
``alink_stream_batches_total`` and ``alink_stream_rows_total`` by
``op``), :class:`BatchApplyStreamOp` (which hands its ``device=`` to a
batch op that takes one, resolved at construction) and
:class:`FnStreamOp`.
"""

from __future__ import annotations

import copy
import heapq
import inspect
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

from ...common.device import resolve_device
from ...common.metrics import get_registry, metrics_enabled
from ...common.mtable import MTable
from ...common.tracing import trace_complete
from ...common.types import TableSchema
from ..base import StreamOperator, TableSourceBatchOp

TimedBatch = Tuple[float, MTable]


def merge_timed(*streams: Iterable[TimedBatch]) -> Iterator[Tuple[float, int, MTable]]:
    """Merge timed streams in event-time order; yields (time, stream_idx, table).

    Ties break by stream index (earlier input wins), matching the reference's
    model-stream-then-data convention for co-flat-map operators.
    """
    def tag(i, s):
        for t, mt in s:
            yield (t, i, mt)

    return heapq.merge(*[tag(i, s) for i, s in enumerate(streams)],
                       key=lambda x: (x[0], x[1]))


# sentinel a _transform may return to end the drain early (FirstN etc.)
STOP = object()


class BaseStreamTransformOp(StreamOperator):
    """Single-input, per-batch stream transform.

    Subclasses implement ``_open(in_schema) -> out_schema`` (schema + state
    init per drain) and ``_transform(mt) -> MTable | None | STOP``. Each
    drain of the DAG replays the stream from the source; per-drain state set
    in ``_open`` lives on a shallow *copy* of the operator, so concurrent
    drains of the same instance (diamond DAGs, side streams) don't share
    mutable state.
    """

    def _open(self, in_schema: TableSchema) -> TableSchema:
        return in_schema

    def _transform(self, mt: MTable) -> Optional[MTable]:  # pragma: no cover
        raise NotImplementedError

    def _close(self):
        """Yielded-after-input-end hook; return iterable of MTable or None."""
        return None

    def link_from(self, in_op: StreamOperator) -> "BaseStreamTransformOp":
        try:
            self._schema = self._open(in_op.get_schema())
        except RuntimeError:
            self._schema = None  # upstream schema data-dependent; resolve on first batch

        def gen():
            worker = copy.copy(self)  # per-drain mutable state lives here
            opened = False
            last_t = 0.0
            # per-drain telemetry, resolved once a drain
            mx = metrics_enabled()
            reg = get_registry() if mx else None
            lbl = {"op": type(self).__name__}
            for t, mt in in_op.timed_batches():
                if not opened:
                    self._schema = worker._open(mt.schema)
                    opened = True
                last_t = t
                t0 = time.perf_counter()
                out = worker._transform(mt)
                dt = time.perf_counter() - t0
                # retroactive span: this generator suspends at ``yield``
                # in the caller's context, so a span held open across it
                # would adopt unrelated downstream spans as children
                trace_complete(f"stream:{type(self).__name__}", dt,
                               cat="stream",
                               args={"rows": mt.num_rows,
                                     "event_time": t})
                if mx:
                    reg.observe("alink_stream_batch_seconds", dt, lbl)
                    reg.inc("alink_stream_batches_total", 1, lbl)
                    reg.inc("alink_stream_rows_total", mt.num_rows, lbl)
                if out is STOP:
                    break
                if out is not None and out.num_rows > 0:
                    yield (t, out)
            tail = worker._close()
            if tail:
                for out in tail:
                    if out is not None and out.num_rows > 0:
                        yield (last_t, out)

        self._stream_fn = gen
        return self


class BatchApplyStreamOp(BaseStreamTransformOp):
    """Apply a stateless batch op class to every micro-batch.

    The class comes either from a subclass overriding ``_batch_cls`` or
    from the ``batch_cls=`` constructor argument (the same injection
    pattern as ModelMapStreamOp's ``mapper_cls=``).
    """

    def __init__(self, params=None, batch_cls=None, device=None, **kwargs):
        super().__init__(params, **kwargs)
        if batch_cls is not None:
            self._injected_batch_cls = batch_cls
        # a batch op that takes a device gets this one, resolved here
        self._op_kw = {}
        if "device" in inspect.signature(
                self._batch_cls().__init__).parameters:
            self.device = resolve_device(device)
            self._op_kw = {"device": self.device}

    def _batch_cls(self):
        cls = getattr(self, "_injected_batch_cls", None)
        if cls is None:
            raise NotImplementedError(
                f"{type(self).__name__}: override _batch_cls or pass batch_cls=")
        return cls

    def _open(self, in_schema):
        probe = self._batch_cls()(self.params.clone(), **self._op_kw)
        probe.link_from(TableSourceBatchOp(MTable([], in_schema)))
        return probe.get_schema()

    def _transform(self, mt):
        op = self._batch_cls()(self.params.clone(), **self._op_kw)
        op.link_from(TableSourceBatchOp(mt))
        return op.get_output_table()


class FnStreamOp(BaseStreamTransformOp):
    """Ad-hoc per-batch function stream op (UDF-style, reference
    stream/utils UDF ops)."""

    def __init__(self, fn: Callable[[MTable], Optional[MTable]],
                 schema_fn: Optional[Callable[[TableSchema], TableSchema]] = None,
                 params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._fn = fn
        self._schema_fn = schema_fn

    def _open(self, in_schema):
        return self._schema_fn(in_schema) if self._schema_fn else in_schema

    def _transform(self, mt):
        return self._fn(mt)
