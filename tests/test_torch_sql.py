"""Slice 25 of the port: the SQL ops (``operator/batch/sql``,
``operator/stream/sql``) and the ``BatchOperator`` / ``StreamOperator``
SQL helpers, on the CPU against the JAX package.

The same seeded tables go through the JAX op and the port's; host ops,
so the tables are held exactly: the same column names and types, and
the same cells (floats bitwise, NaN where NaN, the rest by ``str``).
"""

import numpy as np
import pytest

from alink_tpu.common.mtable import MTable as JT
from alink_tpu.operator.base import TableSourceBatchOp as JSrc
from alink_tpu.operator.batch import sql as jsql
from alink_tpu.operator.stream import sql as jssql
from alink_tpu.operator.stream.source.sources import \
    MemSourceStreamOp as JMemS
from alink_tpu_torch.common.mtable import MTable as TT
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch import sql as tsql
from alink_tpu_torch.operator.stream import sql as tssql
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemS

SCHEMA = "id LONG, x DOUBLE, y DOUBLE, s STRING, k LONG"


def _rows(n=60, seed=0):
    rng = np.random.RandomState(seed)
    names = ["ab", "cd", "ef", None, "gh"]
    return [(i, float(rng.randn()), float(rng.rand() * 10),
             names[rng.randint(0, 5)], int(rng.randint(0, 4)))
            for i in range(n)]


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    return ("o", str(v))


def same(got, want):
    """Port table ``got`` equals JAX table ``want`` exactly."""
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    assert got.num_rows == want.num_rows
    for c in got.col_names:
        assert [_cell(v) for v in got.col(c)] == \
            [_cell(v) for v in want.col(c)], c


def _pair(rows=None, schema=SCHEMA):
    rows = _rows() if rows is None else rows
    return TSrc(TT(rows, schema)), JSrc(JT(rows, schema))


@pytest.mark.parametrize("clause", [
    "*", "id, x", "x * 2 + y as z, s", "id, upper(s) as u",
    "abs(x) as ax, sqrt(y) as ry, cast_long(y) as ly",
    "concat(s, k) as c", "x if x > 0 else y as m", "k, x > 0 as pos"])
def test_select_matches(clause):
    t, j = _pair()
    same(tsql.SelectBatchOp(clause=clause).link_from(t).get_output_table(),
         jsql.SelectBatchOp(clause=clause).link_from(j).get_output_table())


@pytest.mark.parametrize("clause", [
    "x > 0", "x > 0 and s != 'ab'", "k in (1, 3)", "s == 'cd' or y < 2",
    "not (k == 0)", "0 < y < 5"])
def test_where_and_filter_match(clause):
    t, j = _pair()
    for tc, jc in ((tsql.WhereBatchOp, jsql.WhereBatchOp),
                   (tsql.FilterBatchOp, jsql.FilterBatchOp)):
        same(tc(clause=clause).link_from(t).get_output_table(),
             jc(clause=clause).link_from(j).get_output_table())


def test_unsafe_expressions_are_refused_as_there():
    t, j = _pair()
    for mod, src in ((tsql, t), (jsql, j)):
        with pytest.raises(ValueError):
            mod.WhereBatchOp(clause="__import__('os')").link_from(src)
        with pytest.raises(ValueError):
            mod.SelectBatchOp(clause="x.real").link_from(src)


@pytest.mark.parametrize("by,sel", [
    ("k", "k, count(*) as n, sum(x) as sx, avg(y) as ay"),
    ("k, s", "k, s, min(x) as lo, max(x) as hi, stddev(y) as sd"),
    ("s", "s, variance(x) as v, first(id) as f, last(id) as l")])
def test_group_by_matches(by, sel):
    t, j = _pair()
    same(tsql.GroupByBatchOp(group_by_predicate=by, select_clause=sel)
         .link_from(t).get_output_table(),
         jsql.GroupByBatchOp(group_by_predicate=by, select_clause=sel)
         .link_from(j).get_output_table())


def test_order_by_distinct_as_match():
    t, j = _pair()
    for asc in (True, False):
        same(tsql.OrderByBatchOp(clause="y", ascending=asc, limit=7)
             .link_from(t).get_output_table(),
             jsql.OrderByBatchOp(clause="y", ascending=asc, limit=7)
             .link_from(j).get_output_table())
    sub = "k, s"
    same(tsql.DistinctBatchOp().link_from(
        tsql.SelectBatchOp(clause=sub).link_from(t)).get_output_table(),
        jsql.DistinctBatchOp().link_from(
            jsql.SelectBatchOp(clause=sub).link_from(j)).get_output_table())
    names = "a, b, c, d, e"
    same(tsql.AsBatchOp(clause=names).link_from(t).get_output_table(),
         jsql.AsBatchOp(clause=names).link_from(j).get_output_table())


@pytest.mark.parametrize("name", ["UnionAllBatchOp", "UnionBatchOp",
                                  "IntersectBatchOp", "IntersectAllBatchOp",
                                  "MinusBatchOp", "MinusAllBatchOp"])
def test_set_ops_match(name):
    a, b = _rows(40, 1), _rows(40, 2)
    a = [(r[0] % 7, 0.0, 0.0, r[3], r[4]) for r in a]
    b = [(r[0] % 5, 0.0, 0.0, r[3], r[4]) for r in b]
    ta, ja = _pair(a)
    tb, jb = _pair(b)
    same(getattr(tsql, name)().link_from(ta, tb).get_output_table(),
         getattr(jsql, name)().link_from(ja, jb).get_output_table())


@pytest.mark.parametrize("name", ["JoinBatchOp", "LeftOuterJoinBatchOp",
                                  "RightOuterJoinBatchOp",
                                  "FullOuterJoinBatchOp"])
def test_joins_match(name):
    right = [(k, f"name{k}", float(k) / 3) for k in (0, 1, 2, 5, 2)]
    rs = "k LONG, label STRING, w DOUBLE"
    t, j = _pair()
    tr, jr = TSrc(TT(right, rs)), JSrc(JT(right, rs))
    for sel in ("*", "id, label, w"):
        kw = dict(join_predicate="a.k = b.k", select_clause=sel)
        same(getattr(tsql, name)(**kw).link_from(t, tr).get_output_table(),
             getattr(jsql, name)(**kw).link_from(j, jr).get_output_table())


def test_cross_matches():
    small = [(1, "u"), (2, "v"), (3, "w")]
    t, j = _pair(_rows(5))
    tr, jr = TSrc(TT(small, "k LONG, t STRING")), JSrc(JT(small,
                                                          "k LONG, t STRING"))
    same(tsql.CrossBatchOp().link_from(t, tr).get_output_table(),
         jsql.CrossBatchOp().link_from(j, jr).get_output_table())


def test_batch_operator_sql_helpers_match():
    t, j = _pair()
    for f in (lambda o: o.select("id, x * 3 as x3"),
              lambda o: o.select(["id", "s"]),
              lambda o: o.alias(["a", "b", "c", "d", "e"]),
              lambda o: o.where("x > 0.5"), lambda o: o.filter("k == 2"),
              lambda o: o.select("k, s").distinct(),
              lambda o: o.order_by("x", limit=5, ascending=False),
              lambda o: o.group_by("k", "k, count(*) as n"),
              lambda o: o.union_all(o), lambda o: o.first_n(4)):
        same(f(t).get_output_table(), f(j).get_output_table())
    assert t.collect() and [tuple(map(_cell, r)) for r in t.collect()] == \
        [tuple(map(_cell, r)) for r in j.collect()]


def _stream_pair(rows, batch_size=16):
    return (TMemS(rows, SCHEMA, batch_size=batch_size),
            JMemS(rows, SCHEMA, batch_size=batch_size))


def _drain(op):
    return [(t, mt) for t, mt in op.timed_batches()]


def _same_streams(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("make", [
    lambda m: m.SelectStreamOp(clause="id, x + y as z"),
    lambda m: m.WhereStreamOp(clause="s == 'ab' or k > 1"),
    lambda m: m.FilterStreamOp(clause="x < 0"),
    lambda m: m.AsStreamOp(clause="a, b, c, d, e")])
def test_stream_sql_ops_match(make):
    ts, js = _stream_pair(_rows(70))
    _same_streams(_drain(make(tssql).link_from(ts)),
                  _drain(make(jssql).link_from(js)))


def test_stream_union_all_and_helpers_match():
    t1, j1 = _stream_pair(_rows(30, 3), 8)
    t2, j2 = _stream_pair(_rows(20, 4), 6)
    _same_streams(_drain(tssql.UnionAllStreamOp().link_from(t1, t2)),
                  _drain(jssql.UnionAllStreamOp().link_from(j1, j2)))
    _same_streams(_drain(t1.select("id, s").where("id > 3")),
                  _drain(j1.select("id, s").where("id > 3")))
    _same_streams(_drain(t1.union_all(t2)), _drain(j1.union_all(j2)))


@pytest.mark.parametrize("length,slide", [(2.0, None), (3.0, 1.0)])
def test_window_group_by_matches(length, slide):
    kw = dict(group_by_clause="k", select_clause="k, count(*) as n, "
              "sum(x) as sx", window_length=length)
    if slide is not None:
        kw["slide_length"] = slide
    ts, js = _stream_pair(_rows(100, 5), 10)
    got = _drain(tssql.WindowGroupByStreamOp(**kw).link_from(ts))
    want = _drain(jssql.WindowGroupByStreamOp(**kw).link_from(js))
    assert len(got) > 3
    _same_streams(got, want)
