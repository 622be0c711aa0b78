"""Pipeline wrappers: NLP.

Counterpart: ``alink_tpu/pipeline/nlp.py`` (the reference's pipeline/nlp/):
``Tokenizer``, ``RegexTokenizer``, ``NGram``, ``StopWordsRemover``,
``DocCountVectorizer``, ``DocHashCountVectorizer`` and ``Word2Vec`` with
their models. ``Word2Vec`` trains on its ``device`` (``cuda`` unless
given ``device="cpu"``). ``Segment`` waits for the segmenter (ROADMAP
A7(c)).
"""

from __future__ import annotations

from ..operator.batch.nlp import (DocCountVectorizerTrainBatchOp,
                                  DocHashCountVectorizerTrainBatchOp,
                                  NGramBatchOp, RegexTokenizerBatchOp,
                                  StopWordsRemoverBatchOp,
                                  TokenizerBatchOp, Word2VecTrainBatchOp)
from ..operator.common.nlp.vectorizer import (DocCountVectorizerModelMapper,
                                              DocHashCountVectorizerModelMapper)
from ..operator.common.nlp.word2vec import Word2VecModelMapper
from .feature import BatchOpTransformer, _trainer


def _op_transformer(name, op_cls):
    cls = type(name, (BatchOpTransformer,),
               {"OP_CLS": op_cls, "__module__": __name__})
    cls._PARAM_INFOS = {**op_cls._PARAM_INFOS, **cls._PARAM_INFOS}
    return cls


Tokenizer = _op_transformer("Tokenizer", TokenizerBatchOp)
RegexTokenizer = _op_transformer("RegexTokenizer", RegexTokenizerBatchOp)
NGram = _op_transformer("NGram", NGramBatchOp)
StopWordsRemover = _op_transformer("StopWordsRemover", StopWordsRemoverBatchOp)


DocCountVectorizer, DocCountVectorizerModel = _trainer(
    "DocCountVectorizer", DocCountVectorizerTrainBatchOp,
    DocCountVectorizerModelMapper)
DocHashCountVectorizer, DocHashCountVectorizerModel = _trainer(
    "DocHashCountVectorizer", DocHashCountVectorizerTrainBatchOp,
    DocHashCountVectorizerModelMapper)
Word2Vec, Word2VecModel = _trainer(
    "Word2Vec", Word2VecTrainBatchOp, Word2VecModelMapper)
