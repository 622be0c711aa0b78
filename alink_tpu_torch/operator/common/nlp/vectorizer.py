"""Document vectorizers: the TF / IDF family.

Counterpart: ``alink_tpu/operator/common/nlp/vectorizer.py`` (the
re-design of the reference's DocCountVectorizerTrainBatchOp and
DocHashCountVectorizerTrainBatchOp internals; FeatureType.java's
WORD_COUNT, BINARY, TF, IDF and TF_IDF), copied. Vocabulary and document
frequencies are host-side; the sparse vectors they produce are what
trainers downstream copy to the device. ``_hash_token`` hashes with the
port's own ``operator/batch/feature/feature_ops.py::murmur32``.
"""

from __future__ import annotations

import functools
import json
import math
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....common.vector import SparseVector
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import SimpleModelDataConverter
from .text import _tokens

FEATURE_TYPES = ("WORD_COUNT", "BINARY", "TF", "IDF", "TF_IDF")


def _feature_value(feature_type: str, cnt: float, total: float, idf: float) -> float:
    if feature_type == "WORD_COUNT":
        return cnt
    if feature_type == "BINARY":
        return 1.0
    if feature_type == "TF":
        return cnt / max(total, 1.0)
    if feature_type == "IDF":
        return idf
    if feature_type == "TF_IDF":
        return (cnt / max(total, 1.0)) * idf
    raise ValueError(f"unknown feature type {feature_type}; use {FEATURE_TYPES}")


class DocCountVectorizerModel:
    def __init__(self, vocab: List[str], idf: np.ndarray, feature_type: str,
                 min_tf: float = 1.0):
        self.vocab = vocab
        self.index = {w: i for i, w in enumerate(vocab)}
        self.idf = np.asarray(idf, np.float64)
        self.feature_type = feature_type
        self.min_tf = min_tf


class DocCountVectorizerModelConverter(SimpleModelDataConverter):
    """reference: DocCountVectorizerModelDataConverter (word/idf rows)."""

    def serialize_model(self, m: DocCountVectorizerModel):
        meta = Params({"feature_type": m.feature_type, "min_tf": m.min_tf})
        data = [json.dumps({"word": w, "idf": float(i)})
                for w, i in zip(m.vocab, m.idf)]
        return meta, data

    def deserialize_model(self, meta: Params, data: List[str]):
        words, idfs = [], []
        for s in data:
            d = json.loads(s)
            words.append(d["word"])
            idfs.append(d["idf"])
        return DocCountVectorizerModel(
            words, np.asarray(idfs), meta._m.get("feature_type", "WORD_COUNT"),
            float(meta._m.get("min_tf", 1.0)))


def train_doc_count_vectorizer(table: MTable, selected_col: str,
                               feature_type: str = "WORD_COUNT",
                               max_df: float = float("inf"),
                               min_df: float = 1.0,
                               vocab_size: int = 1 << 18,
                               min_tf: float = 1.0) -> MTable:
    """Vocabulary + smoothed IDF (reference DocCountVectorizerTrainBatchOp)."""
    n_docs = table.num_rows
    df: Counter = Counter()
    for v in table.col(selected_col):
        df.update(set(_tokens(v)))

    def df_bound(b):   # float strictly inside (0,1) means proportion of docs
        if isinstance(b, float) and 0 < b < 1.0:
            return b * n_docs
        return b

    lo, hi = df_bound(min_df), df_bound(max_df)
    items = [(w, c) for w, c in df.items() if lo <= c <= hi]
    items.sort(key=lambda kv: (-kv[1], kv[0]))
    items = items[:vocab_size]
    vocab = [w for w, _ in items]
    idf = np.asarray([math.log((1.0 + n_docs) / (1.0 + c)) for _, c in items])
    model = DocCountVectorizerModel(vocab, idf, feature_type, min_tf)
    return DocCountVectorizerModelConverter().save_model(model)


class DocCountVectorizerModelMapper(ModelMapper):
    """reference: DocCountVectorizerModelMapper — doc -> SparseVector."""

    SELECTED_COL = ParamInfo("selected_col", str, optional=False)
    OUTPUT_COL = ParamInfo("output_col", str)

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[DocCountVectorizerModel] = None

    def load_model(self, model_table: MTable):
        self.model = DocCountVectorizerModelConverter().load_model(model_table)

    def _out_col(self):
        return self.params._m.get("output_col") or self.get_selected_col()

    def get_output_schema(self) -> TableSchema:
        return OutputColsHelper(self.data_schema, [self._out_col()],
                                [AlinkTypes.SPARSE_VECTOR]).get_output_schema()

    def _vectorize(self, text) -> SparseVector:
        m = self.model
        cnt = Counter(t for t in _tokens(text) if t in m.index)
        total = float(sum(cnt.values()))
        min_tf = m.min_tf * total if m.min_tf < 1.0 else m.min_tf
        pairs = sorted((m.index[w], c) for w, c in cnt.items() if c >= min_tf)
        idx = [i for i, _ in pairs]
        val = [_feature_value(m.feature_type, float(c), total, float(m.idf[i]))
               for i, c in pairs]
        return SparseVector(len(m.vocab), idx, val)

    def map_table(self, data: MTable) -> MTable:
        col = data.col(self.get_selected_col())
        out = np.empty(len(col), object)
        out[:] = [self._vectorize(v) for v in col]
        helper = OutputColsHelper(data.schema, [self._out_col()],
                                  [AlinkTypes.SPARSE_VECTOR])
        return helper.build_output(data, [out])


# ---------------------------------------------------------------------------
# hashing variant (no vocabulary; murmur into fixed dim)
# ---------------------------------------------------------------------------

class DocHashCountVectorizerModel:
    def __init__(self, num_features: int, idf_map: Dict[int, float],
                 feature_type: str, min_tf: float = 1.0):
        self.num_features = num_features
        self.idf_map = idf_map
        self.feature_type = feature_type
        self.min_tf = min_tf


class DocHashCountVectorizerModelConverter(SimpleModelDataConverter):
    def serialize_model(self, m: DocHashCountVectorizerModel):
        meta = Params({"num_features": m.num_features,
                       "feature_type": m.feature_type, "min_tf": m.min_tf})
        data = [json.dumps({str(k): v for k, v in m.idf_map.items()})]
        return meta, data

    def deserialize_model(self, meta: Params, data: List[str]):
        idf = {int(k): float(v) for k, v in json.loads(data[0]).items()}
        return DocHashCountVectorizerModel(
            int(meta._m.get("num_features", 1 << 18)), idf,
            meta._m.get("feature_type", "WORD_COUNT"),
            float(meta._m.get("min_tf", 1.0)))


from ...batch.feature.feature_ops import murmur32


@functools.lru_cache(maxsize=1 << 16)
def _hash_token(tok: str, num_features: int) -> int:
    """The token's slot (memoized: a corpus repeats its words)."""
    return murmur32(tok.encode("utf-8")) % num_features


def train_doc_hash_count_vectorizer(table: MTable, selected_col: str,
                                    num_features: int = 1 << 18,
                                    feature_type: str = "WORD_COUNT",
                                    min_df: float = 1.0,
                                    min_tf: float = 1.0) -> MTable:
    n_docs = table.num_rows
    df: Counter = Counter()
    for v in table.col(selected_col):
        df.update({_hash_token(t, num_features) for t in _tokens(v)})
    lo = min_df * n_docs if isinstance(min_df, float) and 0 < min_df < 1.0 else min_df
    idf_map = {h: math.log((1.0 + n_docs) / (1.0 + c))
               for h, c in df.items() if c >= lo}
    model = DocHashCountVectorizerModel(num_features, idf_map, feature_type, min_tf)
    return DocHashCountVectorizerModelConverter().save_model(model)


class DocHashCountVectorizerModelMapper(DocCountVectorizerModelMapper):
    def load_model(self, model_table: MTable):
        self.model = DocHashCountVectorizerModelConverter().load_model(model_table)

    def _vectorize(self, text) -> SparseVector:
        m = self.model
        cnt = Counter(_hash_token(t, m.num_features) for t in _tokens(text))
        cnt = Counter({h: c for h, c in cnt.items() if h in m.idf_map})
        total = float(sum(cnt.values()))
        min_tf = m.min_tf * total if m.min_tf < 1.0 else m.min_tf
        pairs = sorted((h, c) for h, c in cnt.items() if c >= min_tf)
        idx = [h for h, _ in pairs]
        val = [_feature_value(m.feature_type, float(c), total, m.idf_map[h])
               for h, c in pairs]
        return SparseVector(m.num_features, idx, val)
