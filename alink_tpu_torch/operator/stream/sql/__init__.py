"""SQL-style stream operators.

Counterpart: ``alink_tpu/operator/stream/sql/__init__.py``: Select, As,
Where, Filter and UnionAll (the stream subset of the batch SQL family)
and ``WindowGroupByStreamOp`` (stream/sql/WindowGroupByStreamOp.java:
40-75, TUMBLE/HOP windows there; here event-time tumbling or hopping
windows over the micro-batch stream with the batch group-by's aggregate
clause). Host Python; none takes a device.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import TableSchema
from ...base import BatchOperator, StreamOperator
from ...batch.sql import (GroupByBatchOp, SelectBatchOp, _as_bool,
                          evaluate_expr)
from ..core import BaseStreamTransformOp, BatchApplyStreamOp

_CLAUSE = ParamInfo("clause", str, "expression clause", optional=False)


class BaseSqlApiStreamOp(BaseStreamTransformOp):
    """Base of the SQL-clause stream operators (reference
    stream/sql/BaseSqlApiStreamOp.java)."""


class SelectStreamOp(BatchApplyStreamOp):
    """reference: stream/sql/SelectStreamOp."""
    CLAUSE = _CLAUSE

    def _batch_cls(self):
        return SelectBatchOp


class AsStreamOp(BaseStreamTransformOp):
    CLAUSE = _CLAUSE

    def _open(self, in_schema):
        names = [n.strip() for n in self.get_clause().split(",")]
        return TableSchema(names, list(in_schema.types))

    def _transform(self, mt):
        return mt.rename([n.strip() for n in self.get_clause().split(",")])


class WhereStreamOp(BaseStreamTransformOp):
    CLAUSE = _CLAUSE

    def _transform(self, mt):
        return mt.filter_mask(_as_bool(evaluate_expr(mt, self.get_clause())))


class FilterStreamOp(WhereStreamOp):
    pass


class UnionAllStreamOp(StreamOperator):
    """Event-time merge of streams (reference stream/sql/UnionAllStreamOp)."""

    def link_from(self, *inputs: StreamOperator) -> "UnionAllStreamOp":
        from ..core import merge_timed
        try:
            self._schema = inputs[0].get_schema()
        except RuntimeError:
            self._schema = None  # upstream schema data-dependent

        def gen():
            for t, _, mt in merge_timed(*[i.timed_batches() for i in inputs]):
                yield (t, mt)

        self._stream_fn = gen
        return self


class WindowGroupByStreamOp(StreamOperator):
    """Tumbling/hopping event-time window group-by.

    reference: stream/sql/WindowGroupByStreamOp.java:40-75 (TUMBLE/HOP/
    SESSION window SQL). ``window_length`` / ``slide_length`` are in event-
    time units (the sources' simulated seconds); each closed window runs the
    batch group-by aggregate clause and emits one result table stamped with
    the window end.
    """

    GROUP_BY_CLAUSE = ParamInfo("group_by_clause", str, optional=False)
    SELECT_CLAUSE = ParamInfo("select_clause", str, optional=False)
    WINDOW_LENGTH = ParamInfo("window_length", float, default=1.0)
    SLIDE_LENGTH = ParamInfo("slide_length", float, default=None)

    def link_from(self, in_op: StreamOperator) -> "WindowGroupByStreamOp":
        length = float(self.get_window_length())
        slide = self.params._m.get("slide_length") or length

        def agg(tbl: MTable) -> MTable:
            op = GroupByBatchOp(group_by_predicate=self.get_group_by_clause(),
                                select_clause=self.get_select_clause())
            op.link_from(BatchOperator.from_table(tbl))
            return op.get_output_table()

        def window_table(pending, lo, hi):
            """Rows with lo <= t < hi (HOP windows overlap, so rows stay in
            ``pending`` until they age past every window containing them)."""
            parts = [mt for pt, mt in pending if lo <= pt < hi]
            if not parts:
                return None
            whole = parts[0]
            for p in parts[1:]:
                whole = whole.concat_rows(p)
            return whole

        def gen():
            pending: List = []   # (t, MTable), time-ordered
            window_end = None
            for t, mt in in_op.timed_batches():
                if window_end is None:
                    # first slide-aligned window end after t (Flink HOP
                    # emits every `slide`, windows cover [end-length, end))
                    window_end = (np.floor(t / slide) + 1) * slide
                while t >= window_end:
                    whole = window_table(pending, window_end - length, window_end)
                    if whole is not None:
                        yield (window_end, agg(whole))
                    window_end += slide
                    pending = [(pt, m) for pt, m in pending
                               if pt >= window_end - length]
                pending.append((t, mt))
            while pending:
                we = window_end if window_end is not None else length
                whole = window_table(pending, we - length, we)
                if whole is not None:
                    yield (we, agg(whole))
                window_end = we + slide
                pending = [(pt, m) for pt, m in pending
                           if pt >= window_end - length]

        self._stream_fn = gen
        # schema resolved on first window; aggregates can't be probed empty.
        self._schema = None
        return self
