"""Slice 25 of the port: association rules (``operator/common/
associationrule``, ``operator/batch/associationrule``) on the CPU against
the JAX package.

Host search, held exactly: the same frequent itemsets with the same
supports, the same rules with the same lift, support and confidence
(bitwise), in the same order. Also held against numpy: each itemset's
support is its count over the transactions, and each rule's confidence
and lift are computed from those counts.
"""

import numpy as np
import pytest

from alink_tpu.common.mtable import MTable as JT
from alink_tpu.operator.base import TableSourceBatchOp as JSrc
from alink_tpu.operator.batch.associationrule import \
    FpGrowthBatchOp as JFp
from alink_tpu.operator.batch.associationrule import \
    PrefixSpanBatchOp as JPs
from alink_tpu.operator.common import associationrule as jar
from alink_tpu_torch.common.mtable import MTable as TT
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch.associationrule import \
    FpGrowthBatchOp as TFp
from alink_tpu_torch.operator.batch.associationrule import \
    PrefixSpanBatchOp as TPs
from alink_tpu_torch.operator.common import associationrule as tar


def baskets(n, items, mean, seed):
    """Seeded transactions with Zipf-like item frequencies."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, items + 1) ** 1.1
    p /= p.sum()
    out = []
    for _ in range(n):
        k = max(1, rng.poisson(mean))
        out.append(sorted({f"i{int(v)}" for v in rng.choice(items, k, p=p)}))
    return out


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    return ("o", str(v))


def same(got, want):
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    assert [tuple(map(_cell, r)) for r in got.to_rows()] == \
        [tuple(map(_cell, r)) for r in want.to_rows()]


@pytest.mark.parametrize("n,items,support,conf,plen", [
    (400, 30, 0.05, 0.2, 10), (1500, 120, 0.01, 0.05, 3),
    (300, 12, 0.1, 0.5, 2)])
def test_fp_growth_matches_and_counts(n, items, support, conf, plen):
    tx = baskets(n, items, 4.0, n)
    rows = [(",".join(t),) for t in tx]
    kw = dict(items_col="items", min_support_percent=support,
              min_confidence=conf, max_pattern_length=plen)
    t = TFp(**kw).link_from(TSrc(TT(rows, "items STRING")))
    j = JFp(**kw).link_from(JSrc(JT(rows, "items STRING")))
    same(t.get_output_table(), j.get_output_table())
    same(t.get_side_output(0).get_output_table(),
         j.get_side_output(0).get_output_table())
    # numpy: a one-hot basket matrix gives every support by a product
    names = sorted({i for b in tx for i in b})
    col = {v: k for k, v in enumerate(names)}
    M = np.zeros((n, len(names)), bool)
    for r, b in enumerate(tx):
        M[r, [col[i] for i in b]] = True

    def count(itemset):
        return int(M[:, [col[i] for i in itemset]].all(1).sum())
    pats = t.get_output_table()
    assert pats.num_rows > 5
    sup = {}
    for s, c, k in pats.to_rows():
        items_ = s.split(",")
        assert len(items_) == k and count(items_) == c
        sup[tuple(items_)] = c
    rules = t.get_side_output(0).get_output_table()
    for rule, _, lift, sp, cf, c in rules.to_rows():
        a, b = (x.split(",") for x in rule.split("=>"))
        ca, cb, cab = count(a), count(b), count(a + b)
        assert c == cab and cf == cab / ca and sp == cab / n
        assert lift == cab / ca * n / cb


def test_fp_growth_counts_support_and_percent_as_there():
    tx = baskets(200, 10, 3.0, 7)
    rows = [(",".join(t),) for t in tx]
    for kw in (dict(min_support_count=30), dict(min_support_percent=0.2),
               dict(min_support_count=0)):
        kw.update(items_col="items", max_pattern_length=3)
        same(TFp(**kw).link_from(TSrc(TT(rows, "items STRING")))
             .get_output_table(),
             JFp(**kw).link_from(JSrc(JT(rows, "items STRING")))
             .get_output_table())


def test_fp_tree_and_rules_internals_match():
    tx = [[0, 1, 2], [0, 2], [1, 2, 3], [0, 1, 2, 3], [2, 3]]
    assert tar.fp_growth(tx, 2) == jar.fp_growth(tx, 2)
    pats = tar.fp_growth(tx, 2)
    assert tar.extract_rules(pats, 5, 0.1, 0.5, 2) == \
        jar.extract_rules(pats, 5, 0.1, 0.5, 2)
    trees = (tar.FpTree(), jar.FpTree())
    for t in tx:
        for tree in trees:
            tree.add(t)
    for item in range(4):
        assert trees[0].conditional_base(item) == \
            trees[1].conditional_base(item)
    assert sorted(trees[0].conditional_base(3)) == [
        ([0, 1, 2], 1), ([1, 2], 1), ([2], 1)]


def sequences(n, items, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        elems = []
        for _ in range(rng.randint(1, 5)):
            k = rng.randint(1, 3)
            elems.append(",".join(sorted({f"s{int(v)}" for v in
                                          rng.randint(0, items, k)})))
        out.append(";".join(elems))
    return out


@pytest.mark.parametrize("n,items,support", [(120, 8, 0.1), (300, 15, 0.05)])
def test_prefix_span_matches(n, items, support):
    rows = [(s,) for s in sequences(n, items, n)]
    kw = dict(items_col="seq", min_support_percent=support,
              min_confidence=0.1, max_pattern_length=4)
    t = TPs(**kw).link_from(TSrc(TT(rows, "seq STRING")))
    j = JPs(**kw).link_from(JSrc(JT(rows, "seq STRING")))
    assert t.get_output_table().num_rows > 5
    same(t.get_output_table(), j.get_output_table())
    same(t.get_side_output(0).get_output_table(),
         j.get_side_output(0).get_output_table())
    seqs = [[frozenset(e.split(",")) for e in s.split(";")] for (s,) in rows]
    assert tar.prefix_span(seqs, 10, 3) == jar.prefix_span(seqs, 10, 3)
    pats = tar.prefix_span(seqs, 10, 3)
    assert tar.sequence_rules(pats, n, 0.2) == jar.sequence_rules(pats, n,
                                                                  0.2)
