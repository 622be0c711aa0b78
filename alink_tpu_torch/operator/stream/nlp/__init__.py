"""NLP stream operators.

Counterpart: ``alink_tpu/operator/stream/nlp/__init__.py`` (the
reference's operator/stream/nlp/): the map twins of the tokenizers,
``NGram``, ``StopWordsRemover`` and ``Segment``. The vectorizers' and
Word2Vec's predict twins are in ``operator/stream/predict_ops.py``.
"""

from __future__ import annotations

from ....common.params import ParamInfo
from ....params.shared import HasOutputCol, HasSelectedCol
from ...common.nlp.segment import SegmentMapper
from ...common.nlp.text import (NGramMapper, RegexTokenizerMapper,
                                StopWordsRemoverMapper, TokenizerMapper)
from ..utils import MapperStreamOp


class TokenizerStreamOp(MapperStreamOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = TokenizerMapper


class RegexTokenizerStreamOp(MapperStreamOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = RegexTokenizerMapper
    PATTERN = ParamInfo("pattern", str, default=r"\s+")
    GAPS = ParamInfo("gaps", bool, default=True)
    MIN_TOKEN_LENGTH = ParamInfo("min_token_length", int, default=1)
    TO_LOWER_CASE = ParamInfo("to_lower_case", bool, default=True)


class NGramStreamOp(MapperStreamOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = NGramMapper
    N = ParamInfo("n", int, default=2)


class StopWordsRemoverStreamOp(MapperStreamOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = StopWordsRemoverMapper
    CASE_SENSITIVE = ParamInfo("case_sensitive", bool, default=False)
    STOP_WORDS = ParamInfo("stop_words", list)


class SegmentStreamOp(MapperStreamOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = SegmentMapper
    USER_DEFINED_DICT = ParamInfo("user_defined_dict", list)
