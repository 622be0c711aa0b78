"""SQL-style batch operators.

Counterpart: ``alink_tpu/operator/batch/sql/__init__.py``, the
re-design of operator/batch/sql/ (Select, As, Where, Filter, GroupBy,
the five joins, Union[All], Intersect[All], Minus[All], Distinct,
OrderBy, Cross; Flink Table in the reference). Host Python over the
columnar table, as there, with the same small safe expression evaluator
(``_SafeEval`` / ``evaluate_expr``) in place of Calcite SQL; none of
these ops takes a device.

Expression language: python-syntax expressions over column names
(e.g. "sepal_length > 5.0 and species != 'setosa'"); select supports
"col", "expr as alias", "*".
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ...base import BatchOperator

_CLAUSE = ParamInfo("clause", str, "expression clause", optional=False)

_ALLOWED_FUNCS = {
    "abs": np.abs, "sqrt": np.sqrt, "exp": np.exp, "log": np.log, "log2": np.log2,
    "log10": np.log10, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "floor": np.floor, "ceil": np.ceil, "round": np.round, "sign": np.sign,
    "pow": np.power, "power": np.power, "minimum": np.minimum, "maximum": np.maximum,
    "upper": lambda c: _str_map(c, str.upper), "lower": lambda c: _str_map(c, str.lower),
    "cast_double": lambda c: np.asarray(c, np.float64),
    "cast_long": lambda c: np.asarray(c, np.int64),
    "cast_string": lambda c: _str_map(c, str),
    "concat": lambda *cs: _concat_str(cs),
}


def _str_map(col, fn):
    out = np.empty(len(col), object)
    out[:] = [None if v is None else fn(str(v)) for v in col]
    return out


def _concat_str(cols):
    n = len(cols[0])
    out = np.empty(n, object)
    out[:] = ["".join(str(c[i]) for c in cols) for i in range(n)]
    return out


class _SafeEval(ast.NodeVisitor):
    """Whitelisted expression evaluator over table columns."""

    ALLOWED = (ast.Expression, ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Compare,
               ast.Call, ast.Name, ast.Constant, ast.And, ast.Or, ast.Not,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
               ast.FloorDiv, ast.USub, ast.UAdd, ast.Eq, ast.NotEq, ast.Lt,
               ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn, ast.Load,
               ast.Tuple, ast.List, ast.IfExp, ast.Subscript, ast.Index, ast.Slice)

    def __init__(self, cols: Dict[str, np.ndarray]):
        self.cols = cols

    def run(self, expr: str):
        tree = ast.parse(expr, mode="eval")
        for node in ast.walk(tree):
            if not isinstance(node, self.ALLOWED):
                raise ValueError(f"unsupported syntax {type(node).__name__!r} in {expr!r}")
        return self._eval(tree.body)

    def _eval(self, node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.cols:
                return self.cols[node.id]
            if node.id.lower() in ("true", "false"):
                return node.id.lower() == "true"
            if node.id.lower() in ("null", "none"):
                return None
            raise KeyError(f"unknown column {node.id!r}; have {sorted(self.cols)}")
        if isinstance(node, ast.BoolOp):
            vals = [_as_bool(self._eval(v)) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = out & v if isinstance(node.op, ast.And) else out | v
            return out
        if isinstance(node, ast.UnaryOp):
            v = self._eval(node.operand)
            if isinstance(node.op, ast.Not):
                return ~_as_bool(v)
            return -v if isinstance(node.op, ast.USub) else +v
        if isinstance(node, ast.BinOp):
            a, b = self._eval(node.left), self._eval(node.right)
            ops = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
                   ast.Div: np.divide, ast.Mod: np.mod, ast.Pow: np.power,
                   ast.FloorDiv: np.floor_divide}
            return ops[type(node.op)](a, b)
        if isinstance(node, ast.Compare):
            left = self._eval(node.left)
            out = None
            for op, comp in zip(node.ops, node.comparators):
                right = self._eval(comp)
                res = _compare(left, op, right)
                out = res if out is None else (out & res)
                left = right
            return out
        if isinstance(node, ast.Call):
            fname = node.func.id if isinstance(node.func, ast.Name) else None
            if fname is None or fname.lower() not in _ALLOWED_FUNCS:
                raise ValueError(f"unknown function in expression: {ast.dump(node.func)}")
            args = [self._eval(a) for a in node.args]
            return _ALLOWED_FUNCS[fname.lower()](*args)
        if isinstance(node, ast.IfExp):
            c = _as_bool(self._eval(node.test))
            return np.where(c, self._eval(node.body), self._eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return [self._eval(e) for e in node.elts]
        raise ValueError(f"unsupported node {type(node).__name__}")


def _as_bool(v):
    if isinstance(v, np.ndarray) and v.dtype == object:
        return np.asarray([bool(x) for x in v])
    return np.asarray(v, bool)


def _compare(a, op, b):
    if isinstance(op, (ast.In, ast.NotIn)):
        vals = set(b if isinstance(b, (list, tuple)) else [b])
        res = np.asarray([x in vals for x in np.asarray(a, object)])
        return ~res if isinstance(op, ast.NotIn) else res
    if isinstance(a, np.ndarray) and a.dtype == object:
        a2 = np.asarray([str(x) if x is not None else None for x in a], object)
        b2 = str(b) if not isinstance(b, np.ndarray) else b
        ops = {ast.Eq: lambda: a2 == b2, ast.NotEq: lambda: a2 != b2,
               ast.Lt: lambda: a2 < b2, ast.LtE: lambda: a2 <= b2,
               ast.Gt: lambda: a2 > b2, ast.GtE: lambda: a2 >= b2}
        return np.asarray(ops[type(op)](), bool)
    ops = {ast.Eq: np.equal, ast.NotEq: np.not_equal, ast.Lt: np.less,
           ast.LtE: np.less_equal, ast.Gt: np.greater, ast.GtE: np.greater_equal}
    return ops[type(op)](a, b)


def evaluate_expr(table: MTable, expr: str):
    return _SafeEval({n: table.col(n) for n in table.col_names}).run(expr)


def _split_top_level(s: str, sep: str = ",") -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return [p for p in parts if p]


class BaseSqlApiBatchOp(BatchOperator):
    """Base of the SQL-clause operators (reference
    batch/sql/BaseSqlApiBatchOp.java)."""


class SelectBatchOp(BaseSqlApiBatchOp):
    """reference: batch/sql/SelectBatchOp — "a, b*2 as c, *"."""
    CLAUSE = _CLAUSE

    def link_from(self, in_op: BatchOperator) -> "SelectBatchOp":
        t = in_op.get_output_table()
        cols: Dict[str, np.ndarray] = {}
        types: Dict[str, str] = {}
        for item in _split_top_level(self.get_clause()):
            if item == "*":
                for n in t.col_names:
                    cols[n] = t.col(n)
                    types[n] = t.schema.type_of(n)
                continue
            m = re.match(r"^(.*?)\s+[aA][sS]\s+(\w+)$", item)
            expr, name = (m.group(1), m.group(2)) if m else (item, None)
            expr = expr.strip()
            if re.fullmatch(r"\w+", expr) and expr in t.col_names:
                val = t.col(expr)
                vtype = t.schema.type_of(expr)
                name = name or expr
            else:
                val = evaluate_expr(t, expr)
                if not isinstance(val, np.ndarray):
                    val = np.full(t.num_rows, val)
                vtype = AlinkTypes.from_numpy_dtype(val.dtype) \
                    if val.dtype != object else AlinkTypes.STRING
                name = name or re.sub(r"\W+", "_", expr)
            cols[name] = val
            types[name] = vtype
        self._output = MTable(cols, TableSchema(list(cols), [types[n] for n in cols]))
        return self


class AsBatchOp(BaseSqlApiBatchOp):
    """Rename all columns (reference AsBatchOp)."""
    CLAUSE = _CLAUSE

    def link_from(self, in_op: BatchOperator) -> "AsBatchOp":
        names = [n.strip() for n in self.get_clause().split(",")]
        self._output = in_op.get_output_table().rename(names)
        return self


class WhereBatchOp(BaseSqlApiBatchOp):
    CLAUSE = _CLAUSE

    def link_from(self, in_op: BatchOperator) -> "WhereBatchOp":
        t = in_op.get_output_table()
        self._output = t.filter_mask(_as_bool(evaluate_expr(t, self.get_clause())))
        return self


class FilterBatchOp(WhereBatchOp):
    pass


class DistinctBatchOp(BaseSqlApiBatchOp):
    def link_from(self, in_op: BatchOperator) -> "DistinctBatchOp":
        self._output = in_op.get_output_table().distinct()
        return self


class OrderByBatchOp(BaseSqlApiBatchOp):
    CLAUSE = _CLAUSE
    LIMIT = ParamInfo("limit", int, "top-n limit")
    ASCENDING = ParamInfo("ascending", bool, default=True)

    def link_from(self, in_op: BatchOperator) -> "OrderByBatchOp":
        t = in_op.get_output_table()
        self._output = t.order_by(self.get_clause().strip(),
                                  ascending=bool(self.get_ascending()),
                                  limit=self.params._m.get("limit"))
        return self


_AGGS = {
    "sum": np.sum, "avg": np.mean, "mean": np.mean, "min": np.min, "max": np.max,
    "count": len, "stddev": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else 0.0,
    "variance": lambda v: float(np.var(v, ddof=1)) if len(v) > 1 else 0.0,
    "first": lambda v: v[0], "last": lambda v: v[-1],
}


class GroupByBatchOp(BaseSqlApiBatchOp):
    """reference: batch/sql/GroupByBatchOp — group cols + "key, agg(col) as name"."""
    GROUP_BY_PREDICATE = ParamInfo("group_by_predicate", str, optional=False)
    SELECT_CLAUSE = ParamInfo("select_clause", str, optional=False)

    def link_from(self, in_op: BatchOperator) -> "GroupByBatchOp":
        t = in_op.get_output_table()
        by = [c.strip() for c in self.get_group_by_predicate().split(",")]
        groups = t.group_indices(by)
        items = _split_top_level(self.get_select_clause())
        out_cols: Dict[str, List] = {}
        order: List[str] = []
        for key, idx in sorted(groups.items(), key=lambda kv: tuple(map(str, kv[0]))):
            sub = t.take_rows(idx)
            for item in items:
                m = re.match(r"^(.*?)\s+[aA][sS]\s+(\w+)$", item)
                expr, name = (m.group(1).strip(), m.group(2)) if m \
                    else (item.strip(), None)
                fm = re.match(r"^(\w+)\((\*|\w+)\)$", expr)
                if fm:
                    fn, col = fm.group(1).lower(), fm.group(2)
                    name = name or f"{fn}_{col}" if col != "*" else (name or fn)
                    vals = (np.arange(len(idx)) if col == "*"
                            else np.asarray(sub.col(col)))
                    if fn not in _AGGS:
                        raise ValueError(f"unknown aggregate {fn}")
                    v = _AGGS[fn](vals) if fn != "count" else len(idx)
                elif expr in by:
                    name = name or expr
                    v = key[by.index(expr)]
                else:
                    raise ValueError(f"non-aggregate column {expr!r} not in group by")
                if name not in out_cols:
                    out_cols[name] = []
                    order.append(name)
                out_cols[name].append(v)
        self._output = MTable({n: out_cols[n] for n in order})
        return self


class UnionAllBatchOp(BaseSqlApiBatchOp):
    def link_from(self, *inputs: BatchOperator) -> "UnionAllBatchOp":
        t = inputs[0].get_output_table()
        for other in inputs[1:]:
            t = t.concat_rows(other.get_output_table())
        self._output = t
        return self


class UnionBatchOp(BaseSqlApiBatchOp):
    def link_from(self, *inputs: BatchOperator) -> "UnionBatchOp":
        t = UnionAllBatchOp().link_from(*inputs).get_output_table()
        self._output = t.distinct()
        return self


class IntersectBatchOp(BaseSqlApiBatchOp):
    _ALL = False

    def link_from(self, a: BatchOperator, b: BatchOperator):
        ta, tb = a.get_output_table(), b.get_output_table()
        from ....common.mtable import _hashable
        bset = {}
        for r in tb.rows():
            k = tuple(_hashable(v) for v in r)
            bset[k] = bset.get(k, 0) + 1
        keep = []
        for i, r in enumerate(ta.rows()):
            k = tuple(_hashable(v) for v in r)
            if bset.get(k, 0) > 0:
                keep.append(i)
                if not self._ALL:
                    bset[k] = 0
        self._output = ta.take_rows(keep)
        if not self._ALL:
            self._output = self._output.distinct()
        return self


class IntersectAllBatchOp(IntersectBatchOp):
    _ALL = True


class MinusBatchOp(BaseSqlApiBatchOp):
    _ALL = False

    def link_from(self, a: BatchOperator, b: BatchOperator):
        ta, tb = a.get_output_table(), b.get_output_table()
        from ....common.mtable import _hashable
        bset = {}
        for r in tb.rows():
            k = tuple(_hashable(v) for v in r)
            bset[k] = bset.get(k, 0) + 1
        keep = []
        for i, r in enumerate(ta.rows()):
            k = tuple(_hashable(v) for v in r)
            if self._ALL:
                # multiset semantics: consume one b-occurrence per match
                if bset.get(k, 0) > 0:
                    bset[k] -= 1
                    continue
            elif k in bset:
                continue
            keep.append(i)
        self._output = ta.take_rows(keep)
        if not self._ALL:
            self._output = self._output.distinct()
        return self


class MinusAllBatchOp(MinusBatchOp):
    _ALL = True


class JoinBatchOp(BaseSqlApiBatchOp):
    """reference: batch/sql/JoinBatchOp (+Left/Right/Full/Cross variants)."""
    JOIN_PREDICATE = ParamInfo("join_predicate", str, "a.col = b.col [and ...]",
                               optional=False)
    SELECT_CLAUSE = ParamInfo("select_clause", str, default="*")
    TYPE = ParamInfo("type", str, default="join",
                     aliases=("join_type",))

    def link_from(self, a: BatchOperator, b: BatchOperator) -> "JoinBatchOp":
        ta, tb = a.get_output_table(), b.get_output_table()
        pred = self.get_join_predicate()
        pairs = []
        for part in re.split(r"\s+and\s+", pred, flags=re.I):
            m = re.match(r"^\s*a\.(\w+)\s*=+\s*b\.(\w+)\s*$", part.strip(), re.I)
            if not m:
                m2 = re.match(r"^\s*(\w+)\s*=+\s*(\w+)\s*$", part.strip())
                if not m2:
                    raise ValueError(f"unsupported join predicate {part!r}")
                pairs.append((m2.group(1), m2.group(2)))
            else:
                pairs.append((m.group(1), m.group(2)))
        jtype = (self.get_type() or "join").lower()
        self._output = _hash_join(ta, tb, pairs, jtype)
        sel = self.get_select_clause()
        if sel and sel != "*":
            self._output = SelectBatchOp(clause=sel).link_from(
                BatchOperator.from_table(self._output)).get_output_table()
        return self


class LeftOuterJoinBatchOp(JoinBatchOp):
    TYPE = ParamInfo("type", str, default="leftOuterJoin")


class RightOuterJoinBatchOp(JoinBatchOp):
    TYPE = ParamInfo("type", str, default="rightOuterJoin")


class FullOuterJoinBatchOp(JoinBatchOp):
    TYPE = ParamInfo("type", str, default="fullOuterJoin")


class CrossBatchOp(BaseSqlApiBatchOp):
    def link_from(self, a: BatchOperator, b: BatchOperator) -> "CrossBatchOp":
        ta, tb = a.get_output_table(), b.get_output_table()
        na, nb = ta.num_rows, tb.num_rows
        ia = np.repeat(np.arange(na), nb)
        ib = np.tile(np.arange(nb), na)
        left = ta.take_rows(ia)
        right = tb.take_rows(ib)
        cols = {n: left.col(n) for n in left.col_names}
        for n in right.col_names:
            cols[n if n not in cols else n + "_r"] = right.col(n)
        self._output = MTable(cols)
        return self


def _hash_join(ta: MTable, tb: MTable, pairs, jtype: str) -> MTable:
    from ....common.mtable import _hashable
    la = [p[0] for p in pairs]
    lb = [p[1] for p in pairs]
    index: Dict[tuple, List[int]] = {}
    bcols = [tb.col(c) for c in lb]
    for j in range(tb.num_rows):
        k = tuple(_hashable(c[j]) for c in bcols)
        index.setdefault(k, []).append(j)
    acols = [ta.col(c) for c in la]
    ia, ib = [], []
    matched_b = set()
    for i in range(ta.num_rows):
        k = tuple(_hashable(c[i]) for c in acols)
        js = index.get(k, [])
        for j in js:
            ia.append(i)
            ib.append(j)
            matched_b.add(j)
        if not js and jtype in ("leftouterjoin", "fullouterjoin"):
            ia.append(i)
            ib.append(-1)
    if jtype in ("rightouterjoin", "fullouterjoin"):
        for j in range(tb.num_rows):
            if j not in matched_b:
                ia.append(-1)
                ib.append(j)
    bname_map = {n: (n if n not in set(ta.col_names) else n + "_r")
                 for n in tb.col_names}
    cols: Dict[str, List] = {n: [] for n in ta.col_names}
    cols.update({bname_map[n]: [] for n in tb.col_names})
    for i, j in zip(ia, ib):
        ra = ta.row(i) if i >= 0 else (None,) * len(ta.col_names)
        rb = tb.row(j) if j >= 0 else (None,) * len(tb.col_names)
        for n, v in zip(ta.col_names, ra):
            cols[n].append(v)
        for n, v in zip(tb.col_names, rb):
            cols[bname_map[n]].append(v)
    return MTable(cols)
