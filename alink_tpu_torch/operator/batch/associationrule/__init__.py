"""Association-rule batch operators.

Counterpart: ``alink_tpu/operator/batch/associationrule/__init__.py``,
the re-design of operator/batch/associationrule/FpGrowthBatchOp.java and
PrefixSpanBatchOp.java. Output schemas and separators mirror the
reference (ITEMSETS_COL_NAMES / RULES_COL_NAMES, FpGrowthBatchOp.java:
57-66; PrefixSpanBatchOp.java:40-62): the frequent patterns are the main
output, the rules side output 0. Host; neither op takes a device.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List

from ....common.mtable import MTable
from ....common.params import ParamInfo, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ...base import BatchOperator
from ...common.associationrule import (extract_rules, fp_growth, prefix_span,
                                       sequence_rules)

ITEM_SEPARATOR = ","
ELEMENT_SEPARATOR = ";"
RULE_SEPARATOR = "=>"


class _AssocParams:
    """params/associationrule/FpGrowthParams.java (shared Has* mixins under
    params/shared/associationrules/)."""
    ITEMS_COL = ParamInfo("items_col", str, "column of item transactions",
                          optional=False)
    MIN_SUPPORT_COUNT = ParamInfo(
        "min_support_count", int,
        "min support as count; -1 means use min_support_percent", default=-1)
    MIN_SUPPORT_PERCENT = ParamInfo(
        "min_support_percent", float, "min support as fraction", default=0.02,
        validator=RangeValidator(0.0, 1.0))
    MIN_CONFIDENCE = ParamInfo("min_confidence", float, "min rule confidence",
                               default=0.05, validator=RangeValidator(0.0, 1.0))
    MAX_PATTERN_LENGTH = ParamInfo("max_pattern_length", int,
                                   "max items per pattern", default=10)


def _min_support(n: int, count: int, percent: float) -> int:
    """FpGrowthBatchOp.getMinSupportCnt semantics."""
    return count if count >= 0 else int(math.floor(n * percent))


class FpGrowthBatchOp(BatchOperator, _AssocParams):
    """reference: operator/batch/associationrule/FpGrowthBatchOp.java"""
    MAX_CONSEQUENT_LENGTH = ParamInfo("max_consequent_length", int,
                                      "max items on rule rhs", default=1)
    MIN_LIFT = ParamInfo("min_lift", float, "min rule lift", default=1.0)

    def link_from(self, in_op: BatchOperator) -> "FpGrowthBatchOp":
        t = in_op.get_output_table()
        col = self.get_items_col()
        raw: List[set] = []
        for v in t.col(col):
            s = str(v).strip() if v is not None else ""
            raw.append({x for x in s.split(ITEM_SEPARATOR) if x} if s else set())
        n = len(raw)
        min_sup = max(_min_support(n, self.get_min_support_count(),
                                   self.get_min_support_percent()), 1)
        # support-ordered int encoding, infrequent items dropped
        # (FpGrowthBatchOp.java qualifiedItems/itemIndex stages)
        counts = Counter(it for s in raw for it in s)
        qualified = sorted((it for it, c in counts.items() if c >= min_sup),
                           key=lambda it: (-counts[it], it))
        index = {it: i for i, it in enumerate(qualified)}
        trans = [[index[it] for it in s if it in index] for s in raw]

        patterns = fp_growth(trans, min_sup, self.get_max_pattern_length())
        item_of = qualified

        def fmt(ids) -> str:
            # lexicographic item order (the reference emits support order,
            # FpGrowthBatchOp.concatItems — sorted here for determinism)
            return ITEM_SEPARATOR.join(sorted(item_of[i] for i in ids))

        pat_rows = sorted(((fmt(p), sup, len(p)) for p, sup in patterns.items()),
                          key=lambda r: (r[2], -r[1], r[0]))
        self.set_output_table(MTable(
            pat_rows, TableSchema(["itemset", "supportcount", "itemcount"],
                                  [AlinkTypes.STRING, AlinkTypes.LONG,
                                   AlinkTypes.LONG])))

        rules = extract_rules(patterns, n, self.get_min_confidence(),
                              self.get_min_lift(),
                              self.get_max_consequent_length())
        rule_rows = sorted(
            ((fmt(a) + RULE_SEPARATOR + fmt(c), len(a) + len(c), lift,
              sup_pct, conf, sup)
             for a, c, sup, lift, sup_pct, conf in rules),
            key=lambda r: (r[1], -r[5], r[0]))
        self._side_outputs = [MTable(
            rule_rows,
            TableSchema(["rule", "itemcount", "lift", "support_percent",
                         "confidence_percent", "transaction_count"],
                        [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.DOUBLE,
                         AlinkTypes.DOUBLE, AlinkTypes.DOUBLE, AlinkTypes.LONG]))]
        return self


class PrefixSpanBatchOp(BatchOperator, _AssocParams):
    """reference: operator/batch/associationrule/PrefixSpanBatchOp.java"""

    def link_from(self, in_op: BatchOperator) -> "PrefixSpanBatchOp":
        t = in_op.get_output_table()
        col = self.get_items_col()
        seqs: List[List[frozenset]] = []
        for v in t.col(col):
            s = str(v).strip() if v is not None else ""
            if not s:
                seqs.append([])
                continue
            seqs.append([frozenset(x for x in e.split(ITEM_SEPARATOR) if x)
                         for e in s.split(ELEMENT_SEPARATOR) if e])
        n = len(seqs)
        min_sup = max(_min_support(n, self.get_min_support_count(),
                                   self.get_min_support_percent()), 1)
        patterns = prefix_span(seqs, min_sup, self.get_max_pattern_length())

        def fmt(pat) -> str:
            return ELEMENT_SEPARATOR.join(
                ITEM_SEPARATOR.join(sorted(e)) for e in pat)

        pat_rows = sorted(
            ((fmt(p), sup, sum(len(e) for e in p)) for p, sup in patterns.items()),
            key=lambda r: (r[2], -r[1], r[0]))
        self.set_output_table(MTable(
            pat_rows, TableSchema(["itemset", "supportcount", "itemcount"],
                                  [AlinkTypes.STRING, AlinkTypes.LONG,
                                   AlinkTypes.LONG])))

        rules = sequence_rules(patterns, n, self.get_min_confidence())
        rule_rows = sorted(
            ((fmt(a) + RULE_SEPARATOR + ITEM_SEPARATOR.join(sorted(c)),
              len(a) + 1, sup_pct, conf, sup)
             for a, c, sup, sup_pct, conf in rules),
            key=lambda r: (r[1], -r[4], r[0]))
        self._side_outputs = [MTable(
            rule_rows,
            TableSchema(["rule", "chain_length", "support", "confidence",
                         "transaction_count"],
                        [AlinkTypes.STRING, AlinkTypes.LONG, AlinkTypes.DOUBLE,
                         AlinkTypes.DOUBLE, AlinkTypes.LONG]))]
        return self
