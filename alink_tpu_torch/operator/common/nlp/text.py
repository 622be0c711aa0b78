"""Text tokenization mappers.

Counterpart: ``alink_tpu/operator/common/nlp/text.py`` (the re-design of
the reference's common/nlp/ Tokenizer, RegexTokenizer, NGram,
StopWordsRemover and WordCountUtil), copied: all host-side string work;
the vectorizers downstream make the tensors. Tokenized output is one
string column of space-joined tokens, as in the reference.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import Mapper, OutputColsHelper

# A compact english stop-word list (reference bundles a stopwords table;
# this is an original list of the usual function words).
DEFAULT_STOP_WORDS = frozenset("""
a an and are as at be by for from has he her his i in is it its of on or
that the their them they this to was were will with you your we our us
not no nor so if then than too very can could do does did done should
would may might must shall about above after again all am any because
been before being below between both but down during each few further
had have having here how into just me more most my myself off once only
other out over own same she some such there these those through under
until up what when where which while who whom why
""".split())


def _tokens(value) -> List[str]:
    if value is None:
        return []
    return [t for t in str(value).split() if t]


class TokenizerMapper(Mapper):
    """Whitespace + lowercase tokenizer (reference nlp/TokenizerMapper)."""

    SELECTED_COL = ParamInfo("selected_col", str, optional=False)
    OUTPUT_COL = ParamInfo("output_col", str)

    def _out_col(self):
        return self.params._m.get("output_col") or self.get_selected_col()

    def get_output_schema(self) -> TableSchema:
        return OutputColsHelper(self.data_schema, [self._out_col()],
                                [AlinkTypes.STRING]).get_output_schema()

    def _map_text(self, s: Optional[str]) -> Optional[str]:
        if s is None:
            return None
        return " ".join(str(s).lower().split())

    def map_table(self, data: MTable) -> MTable:
        col = data.col(self.get_selected_col())
        out = np.empty(len(col), object)
        out[:] = [self._map_text(v) for v in col]
        helper = OutputColsHelper(data.schema, [self._out_col()], [AlinkTypes.STRING])
        return helper.build_output(data, [out])


class RegexTokenizerMapper(TokenizerMapper):
    """reference: nlp/RegexTokenizerMapper — pattern either matches gaps
    or matches tokens; min token length; optional lowercase."""

    PATTERN = ParamInfo("pattern", str, default=r"\s+")
    GAPS = ParamInfo("gaps", bool, default=True)
    MIN_TOKEN_LENGTH = ParamInfo("min_token_length", int, default=1)
    TO_LOWER_CASE = ParamInfo("to_lower_case", bool, default=True)

    def _map_text(self, s):
        if s is None:
            return None
        s = str(s)
        if bool(self.get_to_lower_case()):
            s = s.lower()
        pat = self.get_pattern()
        toks = re.split(pat, s) if bool(self.get_gaps()) else re.findall(pat, s)
        m = int(self.get_min_token_length())
        return " ".join(t for t in toks if len(t) >= m)


class NGramMapper(TokenizerMapper):
    """reference: nlp/NGramMapper — join n-grams with '_'."""

    N = ParamInfo("n", int, default=2)

    def _map_text(self, s):
        if s is None:
            return None
        toks = _tokens(s)
        n = int(self.get_n())
        return " ".join("_".join(toks[i:i + n])
                        for i in range(len(toks) - n + 1))


class StopWordsRemoverMapper(TokenizerMapper):
    """reference: nlp/StopWordsRemoverMapper."""

    CASE_SENSITIVE = ParamInfo("case_sensitive", bool, default=False)
    STOP_WORDS = ParamInfo("stop_words", list, "extra stop words")

    def _stop_set(self):
        if getattr(self, "_cached_stop", None) is None:
            extra = self.params._m.get("stop_words") or []
            base = set(DEFAULT_STOP_WORDS) | set(extra)
            if not bool(self.get_case_sensitive()):
                base = {w.lower() for w in base}
            self._cached_stop = base
        return self._cached_stop

    def _map_text(self, s):
        if s is None:
            return None
        stop = self._stop_set()
        cs = bool(self.get_case_sensitive())
        return " ".join(t for t in _tokens(s)
                        if (t if cs else t.lower()) not in stop)


def word_count(table: MTable, selected_col: str) -> MTable:
    """(word, cnt) table sorted by count desc (reference WordCountUtil)."""
    counter: Counter = Counter()
    for v in table.col(selected_col):
        counter.update(_tokens(v))
    items = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
    return MTable({"word": [w for w, _ in items],
                   "cnt": np.asarray([c for _, c in items], np.int64)},
                  TableSchema(["word", "cnt"], [AlinkTypes.STRING, AlinkTypes.LONG]))
