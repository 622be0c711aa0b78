"""Association-rule mining internals.

Counterpart: ``alink_tpu/operator/common/associationrule/__init__.py``,
the re-design of common/associationrule/ (FpTree.java / FpTreeImpl.java,
ParallelFpGrowth.java, AssociationRule.java, ParallelPrefixSpan.java,
SequenceRule.java): ``FpTree``, ``fp_growth``, ``extract_rules``,
``prefix_span`` and ``sequence_rules``. Host-side combinatorial search
(pure Java on the Flink workers in the reference, no BLAS), compact
Python over int-encoded transactions; the reference's shards of
conditional-pattern bases by tail item become a loop over tail items.
Exact: the same patterns, supports and rules as the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import combinations
from typing import Dict, List, Sequence, Tuple


# ---------------------------------------------------------------------------
# FP-Growth (FpTreeImpl.java)
# ---------------------------------------------------------------------------

class _FpNode:
    __slots__ = ("item", "count", "parent", "children", "next")

    def __init__(self, item: int, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[int, "_FpNode"] = {}
        self.next = None          # header-list chaining


class FpTree:
    """Prefix-tree of support-ordered transactions (FpTreeImpl.java)."""

    def __init__(self):
        self.root = _FpNode(-1, None)
        self.header: Dict[int, _FpNode] = {}

    def add(self, items: Sequence[int], count: int = 1):
        node = self.root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _FpNode(it, node)
                node.children[it] = child
                child.next = self.header.get(it)
                self.header[it] = child
            child.count += count
            node = child

    def conditional_base(self, item: int) -> List[Tuple[List[int], int]]:
        """(prefix-path, count) pairs ending at `item`."""
        out = []
        node = self.header.get(item)
        while node is not None:
            path = []
            p = node.parent
            while p is not None and p.item >= 0:
                path.append(p.item)
                p = p.parent
            if path:
                out.append((path[::-1], node.count))
            node = node.next
        return out


def fp_growth(transactions: List[List[int]], min_support: int,
              max_pattern_length: int = 10) -> Dict[Tuple[int, ...], int]:
    """Mine frequent itemsets from int-encoded transactions.

    Items must already be support-ordered ids (0 = most frequent) with
    infrequent items dropped, as the reference prepares them
    (FpGrowthBatchOp.java itemIndex/transactions stages). Returns
    {sorted-item-tuple: support}.
    """
    if max_pattern_length <= 0:
        return {}

    patterns: Dict[Tuple[int, ...], int] = {}

    def mine(tree: FpTree, suffix: Tuple[int, ...]):
        # items in this (conditional) tree with their support
        counts: Dict[int, int] = defaultdict(int)
        for item, node in tree.header.items():
            while node is not None:
                counts[item] += node.count
                node = node.next
        # grow patterns by each frequent item (descending id = leafward)
        for item in sorted(counts, reverse=True):
            sup = counts[item]
            if sup < min_support:
                continue
            pat = (item,) + suffix
            patterns[tuple(sorted(pat))] = sup
            if len(pat) >= max_pattern_length:
                continue
            base = tree.conditional_base(item)
            if not base:
                continue
            # rebuild conditional tree keeping only frequent prefix items
            sub_counts: Dict[int, int] = defaultdict(int)
            for path, cnt in base:
                for it in path:
                    sub_counts[it] += cnt
            keep = {it for it, c in sub_counts.items() if c >= min_support}
            if not keep:
                continue
            sub = FpTree()
            for path, cnt in base:
                kept = [it for it in path if it in keep]
                if kept:
                    sub.add(kept, cnt)
            mine(sub, pat)

    tree = FpTree()
    for t in transactions:
        if t:
            tree.add(sorted(set(t)))
    mine(tree, ())
    return patterns


def extract_rules(patterns: Dict[Tuple[int, ...], int], n_transactions: int,
                  min_confidence: float, min_lift: float,
                  max_consequent_length: int = 1,
                  ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], int,
                                  float, float, float]]:
    """Association rules from frequent itemsets (AssociationRule.java).

    Returns (antecedent, consequent, support_count, lift, support, confidence)
    tuples. Every sub-itemset of a frequent itemset is frequent, so both
    sides' supports are lookups in `patterns`.
    """
    rules = []
    if max_consequent_length <= 0:
        return rules
    for pat, sup in patterns.items():
        if len(pat) < 2:
            continue
        items = set(pat)
        for clen in range(1, min(max_consequent_length, len(pat) - 1) + 1):
            for cons in combinations(sorted(items), clen):
                ante = tuple(sorted(items - set(cons)))
                sup_a = patterns.get(ante)
                sup_c = patterns.get(tuple(cons))
                if not sup_a or not sup_c:
                    continue
                conf = sup / sup_a
                lift = conf * n_transactions / sup_c
                if conf >= min_confidence and lift >= min_lift:
                    rules.append((ante, cons, sup, lift,
                                  sup / n_transactions, conf))
    return rules


# ---------------------------------------------------------------------------
# PrefixSpan (ParallelPrefixSpan.java)
# ---------------------------------------------------------------------------

def prefix_span(sequences: List[List[frozenset]], min_support: int,
                max_pattern_length: int = 10,
                ) -> Dict[Tuple[frozenset, ...], int]:
    """Mine frequent sequential patterns (elements are itemsets).

    Pattern containment: p is contained in s if there exist increasing
    element positions whose itemsets are supersets of p's elements.
    Returns {pattern (tuple of frozensets): support}. Classic pattern-growth
    with S-extensions (new element) and I-extensions (grow last element);
    the reference shards projected databases by item (ParallelPrefixSpan),
    which collapses to the outer loop here.
    """
    patterns: Dict[Tuple[frozenset, ...], int] = {}

    # projected db entry: (seq_idx, elem_idx, within_last_element_items)
    def grow(pattern: Tuple[frozenset, ...],
             projections: List[Tuple[int, int]]):
        """projections: (sequence index, element index AFTER which to search
        for S-extensions; the element AT index may still be I-extended)."""
        n_items = sum(len(e) for e in pattern)
        if n_items >= max_pattern_length:
            return
        s_counts: Dict = defaultdict(set)
        i_counts: Dict = defaultdict(set)
        last = pattern[-1] if pattern else frozenset()
        for si, ei in projections:
            seq = sequences[si]
            # I-extension candidates: any element at/after the match point
            # that contains `last` can host extra items (> max(last), the
            # standard dedup order). Exact support is recomputed below, so
            # over-generation is harmless but under-generation is not.
            if pattern:
                for j in range(max(ei, 0), len(seq)):
                    if last <= seq[j]:
                        for it in seq[j]:
                            if it not in last and _after(it, last):
                                i_counts[it].add(si)
            # S-extension: any later element
            start = ei + 1 if pattern else 0
            for j in range(start, len(seq)):
                for it in seq[j]:
                    s_counts[it].add(si)
        for it, sids in sorted(i_counts.items()):
            if len(sids) < min_support:
                continue
            new_last = last | {it}
            new_pat = pattern[:-1] + (new_last,)
            # re-match only within the candidate's supporting sequences —
            # the projected-database shrink that makes PrefixSpan scale
            proj = _project(new_pat, sids)
            if len(proj) >= min_support:
                patterns[new_pat] = len(proj)
                grow(new_pat, proj)
        for it, sids in sorted(s_counts.items()):
            if len(sids) < min_support:
                continue
            new_pat = pattern + (frozenset([it]),)
            proj = _project(new_pat, sids)
            if len(proj) >= min_support:
                patterns[new_pat] = len(proj)
                grow(new_pat, proj)

    def _after(it, itemset) -> bool:
        return all(it > x for x in itemset)

    def _project(pattern, candidates) -> List[Tuple[int, int]]:
        """Earliest-match element positions of `pattern` within the
        candidate sequence ids (one (si, pos) per supporting sequence)."""
        out = []
        for si in sorted(candidates):
            pos = _match(sequences[si], pattern)
            if pos is not None:
                out.append((si, pos))
        return out

    def _match(seq, pattern):
        j = 0
        for k, elem in enumerate(pattern):
            while j < len(seq) and not (elem <= seq[j]):
                j += 1
            if j >= len(seq):
                return None
            if k == len(pattern) - 1:
                return j
            j += 1
        return None

    grow((), [(si, -1) for si in range(len(sequences))])
    return patterns


def sequence_rules(patterns: Dict[Tuple[frozenset, ...], int],
                   n_sequences: int, min_confidence: float,
                   ) -> List[Tuple[Tuple[frozenset, ...], frozenset, int,
                                   float, float]]:
    """prefix => last-element rules (SequenceRule.java). Returns
    (antecedent pattern, consequent element, support_count, support,
    confidence) tuples."""
    rules = []
    for pat, sup in patterns.items():
        if len(pat) < 2:
            continue
        ante = pat[:-1]
        sup_a = patterns.get(ante)
        if not sup_a:
            continue
        conf = sup / sup_a
        if conf >= min_confidence:
            rules.append((ante, pat[-1], sup, sup / n_sequences, conf))
    return rules
