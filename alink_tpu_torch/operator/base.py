"""Operator layer base classes.

Counterpart: ``alink_tpu/operator/base.py``. Ported: ``AlgoOperator``,
``BatchOperator`` with its conveniences (``link``, ``collect``,
``collect_mtable``, ``first_n``, ``print``, ``collect_statistics``,
the SQL helpers ``select`` / ``alias`` / ``where`` / ``filter`` /
``distinct`` / ``order_by`` / ``group_by`` / ``union_all``, ``sample``,
``split`` and ``from_table``) and its lazy hooks (``lazy_print``,
``lazy_collect``, ``lazy_collect_mtable``, ``lazy_print_statistics``,
``lazy_print_train_info``, ``lazy_collect_train_info``,
``lazy_print_model_info``), which ``execute()`` fires once;
``TableSourceBatchOp``; and ``StreamOperator`` (``link``,
``timed_batches``, ``micro_batches``, ``print``, ``sample``, ``select``,
``where``, ``union_all``, the sink registry and ``execute``). Every
``BatchOperator`` subclass's ``link_from`` (the eager execute path) is
metered: ``alink_batch_op_seconds``, ``alink_batch_rows_in_total`` and
``alink_batch_rows_out_total`` by ``op`` and a ``link:<Op>`` span; and
``execute`` counts each sink's micro-batches and rows
(``alink_stream_sink_batches_total``, ``_rows_total``).

The port's difference: the lazy hooks register on
``common/lazy.py::lazy_objects_manager()``, not on the session, so they
resolve no device (a host op's ``lazy_print`` works without a card).
Left out: ``get_ml_env`` (each entry point takes its device explicitly).

Execution model (the JAX package's): batch operators compute eagerly
when linked; a stream is a host-side iterator of timed micro-batches
``(event_time, MTable)``, replayed from its sources on every drain.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, List, Optional

from ..common.lazy import lazy_objects_manager
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

    def set_output_table(self, table: MTable):
        self._output = table
        return self

    def get_col_names(self) -> List[str]:
        return list(self.get_schema().names)

    def __repr__(self):
        tail = f" -> {self._output!r}" if self._output is not None else " (unlinked)"
        return f"{type(self).__name__}{tail}"


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

    def get_side_output_count(self) -> int:
        return len(self._side_outputs)

    def link(self, next_op: "BatchOperator") -> "BatchOperator":
        return next_op.link_from(self)

    def link_from(self, *inputs: "BatchOperator") -> "BatchOperator":
        raise NotImplementedError(f"{type(self).__name__}.link_from")

    # -- materialization -------------------------------------------------
    def collect(self) -> List[tuple]:
        return self.get_output_table().to_rows()

    def collect_mtable(self) -> MTable:
        return self.get_output_table()

    def first_n(self, n: int) -> "BatchOperator":
        return TableSourceBatchOp(self.get_output_table().first_n(n))

    def print(self, n: int = -1, title: Optional[str] = None):
        t = self.get_output_table()
        if title:
            print(title)
        print(t.to_display_string(max_rows=n if n > 0 else 20))
        return self

    def execute(self):
        """Fire all pending lazy callbacks (reference triggerLazyEvaluation)."""
        lazy_objects_manager().fire_all()

    # -- lazy hooks ------------------------------------------------------
    def _lazy(self, tag: str, value, cb: Callable[[Any], None]):
        lazy = lazy_objects_manager().gen_lazy((id(self), tag, cb))
        lazy.add_value(value)
        lazy.add_callback(cb)
        return self

    def lazy_print(self, n: int = -1, title: Optional[str] = None) -> "BatchOperator":
        def show(t: MTable):
            if title:
                print(title)
            print(t.to_display_string(max_rows=n if n > 0 else 20))
        return self._lazy("print", self.get_output_table(), show)

    def lazy_collect(self, callback: Callable[[List[tuple]], None]) -> "BatchOperator":
        return self._lazy("collect", self.get_output_table().to_rows(), callback)

    def lazy_collect_mtable(self, callback) -> "BatchOperator":
        return self._lazy("collect_mtable", self.get_output_table(), callback)

    def lazy_print_statistics(self, title: Optional[str] = None) -> "BatchOperator":
        def show(t: MTable):
            from .common.statistics.summarizer import summarize_table
            if title:
                print(title)
            print(summarize_table(t).to_display_string())
        return self._lazy("stats", self.get_output_table(), show)

    def collect_statistics(self):
        """reference BatchOperator.collectStatistics (batch/BatchOperator.java:576-603)."""
        from .common.statistics.summarizer import summarize_table
        return summarize_table(self.get_output_table())

    # -- train/model-info hooks (reference WithTrainInfo / lazyPrintTrainInfo
    # and WithModelInfoBatchOp / lazyPrintModelInfo, fired from Trainer.fit
    # per pipeline/Trainer.java:50-66) ------------------------------------
    def get_train_info(self) -> MTable:
        """Per-iteration training telemetry (loss curve etc.): side output
        0 by convention across trainers."""
        if not self._side_outputs:
            raise RuntimeError(f"{type(self).__name__} emits no train info")
        return self._side_outputs[0]

    def lazy_print_train_info(self, title: Optional[str] = None) -> "BatchOperator":
        def show(t: MTable):
            if title:
                print(title)
            print(t.to_display_string())
        return self._lazy("train_info", self.get_train_info(), show)

    def lazy_collect_train_info(self, callback) -> "BatchOperator":
        return self._lazy("train_info_collect", self.get_train_info(), callback)

    def get_model_info(self) -> MTable:
        """Summary of the trained model table (reference
        ExtractModelInfoBatchOp role): its schema and row count."""
        t = self.get_output_table()
        return MTable({"field": list(t.col_names),
                       "type": [t.schema.type_of(c) for c in t.col_names],
                       "num_rows": [t.num_rows] * len(t.col_names)})

    def lazy_print_model_info(self, title: Optional[str] = None) -> "BatchOperator":
        def show(t: MTable):
            if title:
                print(title)
            print(t.to_display_string())
        return self._lazy("model_info", self.get_model_info(), show)

    # -- SQL-ish conveniences (the ops of batch/sql) ---------------------
    def select(self, fields) -> "BatchOperator":
        from .batch.sql import SelectBatchOp
        return SelectBatchOp(clause=fields if isinstance(fields, str)
                             else ",".join(fields)).link_from(self)

    def alias(self, fields) -> "BatchOperator":
        from .batch.sql import AsBatchOp
        return AsBatchOp(clause=fields if isinstance(fields, str)
                         else ",".join(fields)).link_from(self)

    def where(self, predicate: str) -> "BatchOperator":
        from .batch.sql import WhereBatchOp
        return WhereBatchOp(clause=predicate).link_from(self)

    filter = where

    def distinct(self) -> "BatchOperator":
        from .batch.sql import DistinctBatchOp
        return DistinctBatchOp().link_from(self)

    def order_by(self, field: str, limit: Optional[int] = None,
                 ascending: bool = True) -> "BatchOperator":
        from .batch.sql import OrderByBatchOp
        op = OrderByBatchOp(clause=field, ascending=ascending)
        if limit is not None:
            op.set_limit(limit)
        return op.link_from(self)

    def group_by(self, by: str, select_clause: str) -> "BatchOperator":
        from .batch.sql import GroupByBatchOp
        return GroupByBatchOp(group_by_predicate=by,
                              select_clause=select_clause).link_from(self)

    def union_all(self, other: "BatchOperator") -> "BatchOperator":
        from .batch.sql import UnionAllBatchOp
        return UnionAllBatchOp().link_from(self, other)

    def sample(self, ratio: float, with_replacement: bool = False) -> "BatchOperator":
        from .batch.dataproc import SampleBatchOp
        return SampleBatchOp(ratio=ratio,
                             with_replacement=with_replacement).link_from(self)

    def split(self, fraction: float, seed: int = 0):
        from .batch.dataproc import SplitBatchOp
        op = SplitBatchOp(fraction=fraction, seed=seed).link_from(self)
        return op, op.get_side_output(0)

    @staticmethod
    def from_table(table: MTable) -> "TableSourceBatchOp":
        return TableSourceBatchOp(table)


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

    def link(self, next_op: "StreamOperator") -> "StreamOperator":
        return next_op.link_from(self)

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

    def print(self) -> "StreamOperator":
        self._sinks.append(lambda mt: print(mt.to_display_string()))
        return self._register()

    def sample(self, ratio: float) -> "StreamOperator":
        from .stream.dataproc import SampleStreamOp
        return SampleStreamOp(ratio=ratio).link_from(self)

    def select(self, fields) -> "StreamOperator":
        from .stream.sql import SelectStreamOp
        return SelectStreamOp(clause=fields if isinstance(fields, str)
                              else ",".join(fields)).link_from(self)

    def where(self, predicate: str) -> "StreamOperator":
        from .stream.sql import WhereStreamOp
        return WhereStreamOp(clause=predicate).link_from(self)

    filter = where

    def union_all(self, other: "StreamOperator") -> "StreamOperator":
        from .stream.sql import UnionAllStreamOp
        return UnionAllStreamOp().link_from(self, other)

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
