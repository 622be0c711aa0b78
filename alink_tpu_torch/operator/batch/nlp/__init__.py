"""NLP batch operators.

Counterpart: ``alink_tpu/operator/batch/nlp/__init__.py`` (the re-design
of the reference's operator/batch/nlp/): the tokenizers, ``NGram``,
``StopWordsRemover``, ``WordCount``, the two vectorizers' train and
predict ops, Word2Vec's and ``SegmentBatchOp`` (the dictionary and HMM
segmenter, host code). ``Word2VecTrainBatchOp`` takes ``device=``
(``cuda`` unless the caller asks for the CPU; raises without it) and
trains there in float32.
"""

from __future__ import annotations

from typing import Optional

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.params import ParamInfo, Params
from ....params.shared import HasOutputCol, HasSelectedCol, HasSeed
from ...base import BatchOperator
from ...common.nlp.segment import SegmentMapper
from ...common.nlp.text import (NGramMapper, RegexTokenizerMapper,
                                StopWordsRemoverMapper, TokenizerMapper,
                                word_count)
from ...common.nlp.vectorizer import (DocCountVectorizerModelMapper,
                                      DocHashCountVectorizerModelMapper,
                                      train_doc_count_vectorizer,
                                      train_doc_hash_count_vectorizer)
from ...common.nlp.word2vec import (Word2VecModelMapper, Word2VecParams,
                                    word2vec_model_table, word2vec_train)
from ..utils.model_map import MapBatchOp, ModelMapBatchOp


class TokenizerBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: batch/nlp/TokenizerBatchOp."""
    MAPPER_CLS = TokenizerMapper


class RegexTokenizerBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: batch/nlp/RegexTokenizerBatchOp."""
    MAPPER_CLS = RegexTokenizerMapper
    PATTERN = ParamInfo("pattern", str, default=r"\s+")
    GAPS = ParamInfo("gaps", bool, default=True)
    MIN_TOKEN_LENGTH = ParamInfo("min_token_length", int, default=1)
    TO_LOWER_CASE = ParamInfo("to_lower_case", bool, default=True)


class NGramBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: batch/nlp/NGramBatchOp."""
    MAPPER_CLS = NGramMapper
    N = ParamInfo("n", int, default=2)


class StopWordsRemoverBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: batch/nlp/StopWordsRemoverBatchOp."""
    MAPPER_CLS = StopWordsRemoverMapper
    CASE_SENSITIVE = ParamInfo("case_sensitive", bool, default=False)
    STOP_WORDS = ParamInfo("stop_words", list)


class SegmentBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: batch/nlp/SegmentBatchOp (jieba-ported segmenter)."""
    MAPPER_CLS = SegmentMapper
    USER_DEFINED_DICT = ParamInfo("user_defined_dict", list)


class WordCountBatchOp(BatchOperator, HasSelectedCol):
    """reference: batch/nlp/WordCountBatchOp — (word, cnt)."""

    def link_from(self, in_op: BatchOperator) -> "WordCountBatchOp":
        self._output = word_count(in_op.get_output_table(), self.get_selected_col())
        return self


class DocCountVectorizerTrainBatchOp(BatchOperator, HasSelectedCol):
    """reference: batch/nlp/DocCountVectorizerTrainBatchOp."""
    FEATURE_TYPE = ParamInfo("feature_type", str, default="WORD_COUNT")
    MAX_DF = ParamInfo("max_df", float, default=float("inf"))
    MIN_DF = ParamInfo("min_df", float, default=1.0)
    VOCAB_SIZE = ParamInfo("vocab_size", int, default=1 << 18)
    MIN_TF = ParamInfo("min_tf", float, default=1.0)

    def link_from(self, in_op: BatchOperator) -> "DocCountVectorizerTrainBatchOp":
        self._output = train_doc_count_vectorizer(
            in_op.get_output_table(), self.get_selected_col(),
            feature_type=self.get_feature_type().upper(),
            max_df=float(self.get_max_df()), min_df=float(self.get_min_df()),
            vocab_size=int(self.get_vocab_size()), min_tf=float(self.get_min_tf()))
        return self


class DocCountVectorizerPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = DocCountVectorizerModelMapper


class DocHashCountVectorizerTrainBatchOp(BatchOperator, HasSelectedCol):
    """reference: batch/nlp/DocHashCountVectorizerTrainBatchOp."""
    NUM_FEATURES = ParamInfo("num_features", int, default=1 << 18)
    FEATURE_TYPE = ParamInfo("feature_type", str, default="WORD_COUNT")
    MIN_DF = ParamInfo("min_df", float, default=1.0)
    MIN_TF = ParamInfo("min_tf", float, default=1.0)

    def link_from(self, in_op: BatchOperator) -> "DocHashCountVectorizerTrainBatchOp":
        self._output = train_doc_hash_count_vectorizer(
            in_op.get_output_table(), self.get_selected_col(),
            num_features=int(self.get_num_features()),
            feature_type=self.get_feature_type().upper(),
            min_df=float(self.get_min_df()), min_tf=float(self.get_min_tf()))
        return self


class DocHashCountVectorizerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                           HasOutputCol):
    MAPPER_CLS = DocHashCountVectorizerModelMapper


class Word2VecTrainBatchOp(BatchOperator, HasSelectedCol, HasSeed):
    """reference: batch/nlp/Word2VecTrainBatchOp (skip-gram + hierarchical
    softmax on the BSP engine; model = (word, vec) rows)."""
    VECTOR_SIZE = ParamInfo("vector_size", int, default=100)
    WINDOW = ParamInfo("window", int, default=5)
    MIN_COUNT = ParamInfo("min_count", int, default=5)
    NUM_ITER = ParamInfo("num_iter", int, default=5)
    LEARNING_RATE = ParamInfo("learning_rate", float, default=0.025)
    BATCH_SIZE = ParamInfo("batch_size", int, default=256)

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, in_op: BatchOperator) -> "Word2VecTrainBatchOp":
        p = Word2VecParams(
            vector_size=int(self.get_vector_size()), window=int(self.get_window()),
            min_count=int(self.get_min_count()), num_iter=int(self.get_num_iter()),
            learning_rate=float(self.get_learning_rate()),
            batch_size=int(self.get_batch_size()), seed=int(self.get_seed() or 0))
        vocab, vectors = word2vec_train(in_op.get_output_table(),
                                        self.get_selected_col(), p,
                                        env=MLEnvironment(device=self.device))
        self._output = word2vec_model_table(vocab, vectors)
        return self


class Word2VecPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol):
    MAPPER_CLS = Word2VecModelMapper
